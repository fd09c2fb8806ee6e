"""The paper's own experiment config (§VII-B): small image-classification
network trained with SPACDC-DL on MNIST-shaped data, N=30 workers, T=3.

The paper uses a small conv net; the coded computation operates on the
fully-connected backprop products (Eq. 23-26), so we model the network as
an MLP backbone (784-512-256-10) — the conv frontend is host-side feature
extraction in our reproduction (see examples/spacdc_dl_mnist.py).
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperExperimentConfig:
    n_workers: int = 30
    t_colluding: int = 3
    k_blocks: int = 8
    layer_sizes: tuple = (784, 512, 256, 10)
    lr: float = 0.05
    batch_size: int = 256
    epochs: int = 5
    noise_scale: float = 1.0
    straggler_delay_s: float = 0.02   # artificial sleep() per the paper
    seed: int = 0


CONFIG = PaperExperimentConfig()
