"""PyTorch/CUDA port of the JAX package (the TPU system beside it) for one
NVIDIA H100.

Same cascade (Whisper ASR -> NLLB NMT -> CosyVoice TTS), same module names
under ``ops/``, ``models/`` and ``pipeline/``; the two TPU kernels of the
serving path are hand-written CUDA C++ under ``csrc/``. Entry points run on
the card unless the caller passes ``device="cpu"``.
"""
