"""The benchmark of ``photon_tpu_torch``, the PyTorch and CUDA port.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the CUDA device
and prints one JSON line.  Everything that belongs to one configuration,
traffic mix, metric or kernel lives in a file of its own, found by its name:

  configs/<config>.json    the settings as run, source, reduced, assumed
  traffic/<traffic>.json   the traffic's parameters; ``driver`` names the
                           entry point that serves them
  drivers/<driver>.py      set-up, one request of the window, the outputs
                           and the comparison that decides ``correct``
  endtoend/<metric>.py     an end-to-end metric from the window's record
  metrics/<metric>.py      a per-layer metric from the traced window
  counts/<kernel>.py       a kernel's operations and bytes from its shapes
  reference/               the plain reference (PyTorch, NumPy), which
                           imports nothing of the program

Nothing here imports ``jax`` or ``photon_tpu``.
"""
