"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of SPACDC.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell needs is found by name: its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``, a
data file that names the driver that reads it, ``drivers/<driver>.py``),
the plain reference that decides ``correct`` (``reference/<name>.py``),
and one reader per per-layer metric (``metrics/<metric>.py``).  The
yardstick (work counts, peaks, the trace's reduction) lives here too, so
a change to the program cannot move it.
"""
