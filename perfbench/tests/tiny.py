"""Tiny sizes of the benchmark's cells for the CPU tests: the same code
paths, shapes a test run holds.  The LM computes in float32 here, so the
program and the float32 reference agree to rounding and every planted
fault stands out."""


def fig3(cell):
    cell.config.update(hidden_size=16, intermediate_size=24)
    cell.traffic.update(rows=96, warmup_rounds=3, sample_rounds=4)


def lm(cell, compute_dtype="float32"):
    cell.config.update(hidden_size=64, intermediate_size=96,
                       num_attention_heads=4, num_key_value_heads=4,
                       num_hidden_layers=2, vocab_size=128,
                       compute_dtype=compute_dtype)
    cell.traffic.update(seq_len=16)


FOR = {"fig3.ffn_up": fig3, "phi3.train_4k": lm}
