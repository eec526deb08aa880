"""The benchmark of ``bayesfmmm_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, cell or
per-layer metric is a file of its own, found by its name:

  * ``configs/<config>.json``   the model's sizes and the data it is fitted to
  * ``workloads/<cell>.json``   the entry, its flags, the call sizes, limits
  * ``metrics/<metric>.py``     a per-layer metric's reader
  * ``entries/<entry>.py``      how one kind of call is set up and driven

The yardstick is frozen here: the data generator (``datagen.py``), the
FLOP and byte arithmetic (``counts/``), the plain reference
(``reference/``) and the comparison that decides ``correct``; the faults
its tests plant in the program are ``faults.py``.  Nothing
here imports JAX or the JAX package, and ``reference/`` imports nothing of
``bayesfmmm_torch``.
"""
