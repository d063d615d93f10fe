"""Traffic kinds: one file a kind, ``bench/drivers/<kind>.py``, found by the
``driver`` key of a traffic mix (``bench/traffic/<traffic>.json``).

The contract.  A driver file names one object ``DRIVER`` with:

Required, for a run (``bench/harness.py``):

* ``call(cfg, mix, seed, device)``: one call of the timed window on the
  call's own seed.  It returns a small answer (a number, a digest, a short
  list of tokens): the harness keeps every answer of the window until the
  judgement, so never a tensor that grows with the window.
* ``judge(cfg, mix, calls, device, log)``: ``calls`` are the ``(seed,
  answer)`` pairs the harness drew from the window, ``answer`` None for a
  call that failed, which has to fail one of the numbers.  It holds each
  answer against the plain reference (``bench/reference/``) and returns
  ``{name: {"value": v, "limit": l}}``; the run is correct where every
  ``v <= l``.

Optional, for a run:

* ``setup(cfg, mix, seed, device)``: called once by ``run_cell`` with the
  run's ``--seed``, before the warm-up calls.  It runs inside set-up, so
  ``setup_s`` counts it, and the ``[setup]`` log line gives its time.  It is
  where a model's weights, caches or data are made, on the device, from the
  seed.  The control (below) shares it: it makes the same inputs.
* ``apas(cfg, mix)``: the sense-amp resolves of one call, for
  ``senseamp_roofline`` (the Monte-Carlo kinds).

For the benchmark's CPU tests (``python -m pytest bench``):

* ``small(cfg, mix) -> (cfg, mix)``: new dicts at the sizes the CPU tests
  run at.  Cells that share a configuration file have to cut it alike.
* ``small_control(cfg, mix) -> (cfg, mix)``: the CPU size at which the
  control is caught.
* ``faults``: functions ``fault(monkeypatch)``, named by ``__name__``, each
  breaking the timed path underneath the driver, so that a run comes out
  not correct.
* ``control()``: a driver of the same traffic with the reference, in the
  precision below the configuration's, in the program's place.

The Monte-Carlo kinds (``mc_boolean``, ``mc_not``) are
``bench.mcjudge.McDriver`` objects and define no ``setup``.  Every metric
reader sees the cell through ``Context.driver``, ``.config`` and
``.traffic`` (``bench/harness.py``).

A new kind of cell joins by new files and entries alone: its driver here,
its reference under ``bench/reference/``, its configuration under
``bench/configs/``, its mix under ``bench/traffic/``, a reader under
``bench/metrics/`` for each new metric, and entries in ``BENCHMARK.json``.
The generic tests (``bench/test_bench_*.py``) read every cell from the
manifest; ``bench/fixtures/toy`` is a kind added that way in a test.

The first served model's cell, and the file that holds each part:

* ``bench/configs/<model>.json``: the published configuration with
  ``source``, ``reduced``, ``assumed``, and the deployment it stands for;
* ``bench/drivers/<kind>.py``: ``setup`` makes the weights on the card from
  the run's seed; ``call`` returns a small answer (the served tokens);
  ``judge`` compares logits against the reference; ``faults`` holds at
  least one fault; ``control()`` decides in a lower precision and has to
  fail; ``small`` and ``small_control`` give the CPU sizes;
* ``bench/reference/<model>.py``: a plain float32 forward pass that imports
  nothing of the program, runs with TF32 off, and is computed in blocks so
  that it fits beside the program;
* ``bench/roofline.py`` or a module beside it: the operations and bytes of
  each new kernel, for its ``<kernel>_roofline`` reader in
  ``bench/metrics/``;
* ``BENCHMARK.json``: one ``configs`` entry, one ``workloads`` entry, and
  the cell's name in ``call_ms``'s ``workloads`` (or the serving metrics it
  reports).
"""
