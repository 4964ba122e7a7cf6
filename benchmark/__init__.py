"""The benchmark of the PyTorch/CUDA port (``dmft_ed_tpu_torch``).

One command runs one cell (a configuration under a traffic mix, as
``BENCHMARK.json`` names them) once on the card and prints one JSON line:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by its name:

- ``configs/<config>.json``: the configuration as it is run;
- ``reference/<config>.py``: the plain reference that decides ``correct``;
- ``traffic/<mix>.json``: the parameters of the window's units, and under
  ``cell`` the name of the window's loop;
- ``cells/<cell>.py``: the window's loop (``loop``: DMFT-loop episodes,
  ``gs``: ground-state solves), built from a configuration, a traffic mix,
  the seed and the configuration's reference;
- ``limits/<workload>.json``: each compared number's limit;
- ``metrics/<metric>.py``: reads one metric from the run's records, the
  host clock or the profiler's trace (a quantity split by the end-to-end
  metric it moves, ``<quantity>.<cells>``, may share ``<quantity>.py``).

A cell held out of ``BENCHMARK.json`` keeps its entries in
``held/<cell>.json``, the entries a later PR adds back; the tests and the
limits' readings (``control.py``) run it, the benchmark's runs do not.

The harness (``harness.py``), the trace reader (``trace.py``) and the work
counts (``roofline.py``) are shared. Nothing here imports jax or the JAX
package; the program is reached only through ``dmft_ed_tpu_torch``.
"""
