"""SFT training entry point (train_greek.sh equivalent; the port of the JAX
package's ``train/run.py``).

The reference launches ``torchrun --nproc_per_node=$N cosyvoice/bin/train.py
--train_engine torch_ddp --model llm …`` (train_greek.sh:13-28). The port
trains on one device a process, data-parallel over the processes of a
``torch.distributed`` group joined through ``EST_MESH__COORDINATOR`` /
``NUM_PROCESSES`` / ``PROCESS_ID`` or torchrun's ``env://`` variables (each
process on its ``--device`` card, by default torchrun's ``LOCAL_RANK``)::

    python -m expressive_speech_translation_tpu_torch.train.run \
        --config greek_sft.yaml --data-dir DATA --checkpoint-dir CKPTS

``--device cpu`` trains on the CPU; ``--tiny`` takes a small LM;
``--export-dir DIR`` writes the trained LM as ``DIR/tts_llm``, servable from
``EST_MODELS_DIR``. The YAML accepts the unified config schema
(core/config.py ``train:`` section); resume and the metric logs come from the
executor. Data: Kaldi-style dirs from train/prepare_mcv.py, tokenized on the
fly.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import zlib
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device

log = logging.getLogger(__name__)


class SpeechTokenizerFrontend:
    """wav → 25 Hz FSQ speech tokens — the role CosyVoice's tokenization
    stage plays in the reference data pipeline (greek_sft.yaml:40-91:
    parquet→tokenize→…; the speech tokens the LM trains on come from the
    pretrained speech tokenizer).

    Weights: ``weights`` (``(params, cfg)``) when given, else a baked
    checkpoint under ``EST_MODELS_DIR/speech_tokenizer`` when present, else a
    fixed-seed init — deterministic (same audio → same tokens across
    runs/processes), so the full real-audio path is exercised even
    weightless. Lengths are padded to the JAX package's buckets, so both
    packages tokenize the same padded windows. Runs on the card unless
    ``device="cpu"``."""

    BUCKETS_S = (2, 5, 10, 20, 30)

    def __init__(self, *, device=None, weights=None):
        from ..models import speech_tokenizer as st

        self.device = resolve_device(device)
        self._st = st
        self._params, self.cfg = weights if weights is not None else (None, None)
        models_dir = os.environ.get("EST_MODELS_DIR")
        if self._params is None and models_dir:
            from ..models.loaders import WeightsNotFoundError, load_converted

            try:
                self._params, self.cfg = load_converted(
                    Path(models_dir) / "speech_tokenizer", st.SpeechTokenizerConfig,
                    device=self.device, dtype=torch.float32)
                log.info("speech tokenizer: baked weights from %s", models_dir)
            except WeightsNotFoundError:
                pass
        if self._params is None:
            self.cfg = st.SpeechTokenizerConfig()
            self._params = st.init_speech_tokenizer(1986, self.cfg, self.device)
            log.info("speech tokenizer: fixed-seed weights (deterministic)")

    def tokenize(self, audio_24k: np.ndarray) -> Optional[List[int]]:
        """24 kHz mono samples → speech token ids; None under 100 ms."""
        from ..ops.mel import kaldi_fbank

        x = np.asarray(audio_24k, np.float32).reshape(-1)
        if x.size < 2400:  # < 100 ms
            return None
        bucket_s = next((b for b in self.BUCKETS_S
                         if x.size <= 24_000 * b), self.BUCKETS_S[-1])
        padded = np.zeros(24_000 * bucket_s, np.float32)
        n = min(x.size, padded.size)
        padded[:n] = x[:n]
        with torch.no_grad():
            mel = kaldi_fbank(torch.from_numpy(padded).to(self.device)[None], sr=24_000,
                              frame_length_ms=40.0, frame_shift_ms=20.0, n_mels=self.cfg.n_mels)
            mask = torch.arange(mel.shape[1], device=self.device)[None, :] < n // 480
            ids, tok_mask = self._st.encode(self._params, self.cfg, mel, mask)
        return ids[0][tok_mask[0]].cpu().numpy().astype(int).tolist()

    def __call__(self, wav_path: str) -> Optional[List[int]]:
        """Decode (the libav shim) + tokenize one utterance; None if the file
        is unreadable."""
        from ..media import native

        try:
            audio, _ = native.decode_audio(wav_path, target_rate=24_000, target_channels=1)
        except Exception:  # noqa: BLE001 — container paths, missing files
            return None
        return self.tokenize(audio)


def load_kaldi_dir(data_dir: str | Path, tokenizer_frontend=None, *, device=None) -> List[dict]:
    """wav.scp + text → sample dicts.

    Speech tokens come from the FSQ speech tokenizer applied to the REAL
    audio (the wav→token stage of greek_sft.yaml's data pipeline), a
    :class:`SpeechTokenizerFrontend` on ``device`` unless a
    ``tokenizer_frontend`` (wav path → ids or None) is given. When an
    utterance's wav cannot be decoded (e.g. the reference's container paths
    ``/data/el/clips/...`` on a host without the corpus), a deterministic
    per-utterance proxy keeps the pipeline runnable — and the fallback is
    logged so silent proxy-training is impossible."""
    from ..pipeline.tokenizer import ByteTokenizer

    data = Path(data_dir)
    texts = {}
    for line in (data / "text").read_text(encoding="utf-8").splitlines():
        utt, _, sentence = line.partition(" ")
        texts[utt] = sentence
    tok = ByteTokenizer()
    frontend = tokenizer_frontend
    samples = []
    n_real = n_proxy = 0
    for line in (data / "wav.scp").read_text(encoding="utf-8").splitlines():
        utt, _, wav = line.partition(" ")
        sentence = texts.get(utt, "")
        text_tokens = tok.encode(sentence)[:200]
        speech_tokens = None
        if frontend is None and Path(wav).exists():
            frontend = SpeechTokenizerFrontend(device=device)
        if frontend is not None:
            speech_tokens = frontend(wav)
        if speech_tokens:
            n_real += 1
        else:
            # proxy speech tokens: deterministic per utterance, ~2.5 tokens/char
            # (crc32, NOT hash() — string hashing is salted per process, which
            # would give resumed/multi-worker runs different proxy targets)
            rng = np.random.default_rng(zlib.crc32(utt.encode("utf-8")))
            n_speech = max(int(len(sentence) * 2.5), 4)
            speech_tokens = rng.integers(0, 6561, n_speech).tolist()
            n_proxy += 1
        samples.append({
            "utt_id": utt,
            "wav": wav,
            "text_tokens": text_tokens,
            "speech_tokens": speech_tokens,
            "num_frames": len(speech_tokens),
        })
    if n_proxy:
        log.warning("load_kaldi_dir(%s): %d/%d utterances fell back to proxy "
                    "speech tokens (wav missing/undecodable)", data_dir,
                    n_proxy, n_real + n_proxy)
    else:
        log.info("load_kaldi_dir(%s): %d utterances tokenized from real audio",
                 data_dir, n_real)
    return samples


def tiny_lm_config():
    """The ``--tiny`` speech LM (smoke runs without the 0.5B init cost)."""
    from ..models import cosyvoice as cv, qwen2 as q2

    return cv.SpeechLMConfig(
        backbone=q2.Qwen2Config(hidden=64, layers=2, heads=4, kv_heads=2,
                                ffn_dim=128, max_positions=1024),
        text_vocab=260 + 4, speech_token_size=6561,
    )


def export_tts_llm(params, lm_cfg, export_dir: str | Path) -> Path:
    """Close the train→serve loop: the trained speech LM as the ``tts_llm``
    stage of the port's bake (``EST_MODELS_DIR`` layout). → its directory."""
    from ..models.loaders import save_converted

    out = Path(export_dir) / "tts_llm"
    save_converted(params, lm_cfg, out)
    log.info("exported serving checkpoint to %s", out)
    return out


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", help="YAML config (core/config.py schema)")
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--cv-data-dir")
    parser.add_argument("--checkpoint-dir", default="checkpoints")
    parser.add_argument("--max-epochs", type=int)
    parser.add_argument("--tiny", action="store_true",
                        help="tiny model (smoke runs without 0.5B init cost)")
    parser.add_argument("--export-dir",
                        help="after training, export the speech LM as a "
                             "native tts_llm checkpoint servable via "
                             "EST_MODELS_DIR")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card, torchrun's LOCAL_RANK card "
                             "when set; 'cuda:N' pins card N; 'cpu' to train on the CPU)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    import dataclasses

    from ..core.config import load_config
    from ..models import cosyvoice as cv
    from ..parallel.mesh import global_slots, make_mesh, maybe_initialize_distributed
    from .executor import Executor, batches_from_samples

    cfg = load_config(args.config)
    # join the torch.distributed group (EST_MESH__*) before any card is touched
    maybe_initialize_distributed(cfg.mesh)
    local_rank = os.environ.get("LOCAL_RANK")
    dev = resolve_device(args.device if args.device or local_rank is None
                         else f"cuda:{local_rank}")
    train_cfg = cfg.train
    if args.max_epochs:
        train_cfg = dataclasses.replace(train_cfg, max_epochs=args.max_epochs)

    lm_cfg = tiny_lm_config() if args.tiny else cv.SpeechLMConfig()
    if train_cfg.mtp > 1:
        # MTP heads train alongside the LM and ride the exported checkpoint,
        # so the served model decodes train.mtp tokens per backbone pass
        lm_cfg = dataclasses.replace(lm_cfg, mtp=train_cfg.mtp)

    # one device a process, data-parallel over the processes of a
    # torch.distributed group: a dp=4 step in one process's threads ran
    # 4-6x slower than one card's, four processes as fast (PERF.md §6)
    slots = global_slots([dev])
    mesh = make_mesh(devices=slots) if len(slots) > 1 else None
    rows_multiple = mesh.shape["dp"] if mesh is not None else 1
    executor = Executor(lm_cfg, train_cfg, mesh=mesh, checkpoint_dir=args.checkpoint_dir,
                        device=dev)
    state = executor.init_or_resume()
    log.info("starting at step %d on %s", int(state.step), dev)
    if mesh is not None:
        log.info("data-parallel over %s", mesh)

    train_samples = load_kaldi_dir(args.data_dir, device=dev)
    cv_samples = (load_kaldi_dir(args.cv_data_dir, device=dev) if args.cv_data_dir
                  else train_samples[:8])
    log.info("%d train / %d cv samples", len(train_samples), len(cv_samples))

    def epoch_batches(epoch: int) -> Iterator:
        return batches_from_samples(iter(train_samples), train_cfg,
                                    accum=train_cfg.accum_grad, seed=train_cfg.seed + epoch,
                                    rows_multiple=rows_multiple)

    def cv_batches() -> Iterator:
        return batches_from_samples(iter(cv_samples), train_cfg, accum=1, seed=0,
                                    rows_multiple=rows_multiple)

    sink = None
    if train_cfg.metrics_path:
        from ..obs.kvlogger import JSONOutput

        sink = JSONOutput(train_cfg.metrics_path).writekvs
    state = executor.train(state, epoch_batches, cv_batches=cv_batches, metric_sink=sink)
    log.info("training done at step %d", int(state.step))

    if args.export_dir and executor.writes:
        export_tts_llm(state.params, lm_cfg, args.export_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
