"""The benchmark of ``webradio_tpu_torch`` (the PyTorch and CUDA port).

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints its result line. The pieces, each found by name: ``configs/``
(deployments), ``traffic/`` (mixes), ``metrics/`` (per-layer readers);
``harness`` drives the served path, ``reference`` is the plain float64
chain the outputs are checked against (``check``), ``control`` reads the
check's control, ``roofline`` and ``profile`` hold the yardstick's
arithmetic. Nothing here imports JAX or the JAX package.
"""
