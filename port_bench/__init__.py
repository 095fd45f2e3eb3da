"""The benchmark of the PyTorch/CUDA port (``neural_image_compression_tpu_torch``).

``python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON result line. The harness is driven by data: a cell names a
configuration (``configs/<name>.json``, built by ``families/<family>.py``
with its plain reference in ``reference/<family>.py``), a traffic mix
(``mixes/<name>.json``, read by ``traffic.py`` and driven by
``drivers/<kind>.py``) and its limits (``limits/<cell>.json``); every
metric, end-to-end or per-layer, is read by ``metrics/<name>.py``.
Nothing here imports JAX or the JAX package.
"""
