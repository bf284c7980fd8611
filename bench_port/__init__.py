"""The benchmark of the PyTorch/CUDA port (``expressive_speech_translation_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json``: a configuration from
``configs/``, a traffic mix from ``traffic/`` and the per-layer readers of
``metrics/``, judged against the plain reference in ``reference/``. See
``README.md``.
"""
