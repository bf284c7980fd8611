"""Per-job batch runner (the port's ``batch/runner.py``; the audio front end
runs on ``device``, the card unless ``device="cpu"``).

Parity with Batch-Processing/run_batch_job.py (95 LoC): instantiate the backend
in-process, process one media file, save ``{job_id}.wav`` +
``{job_id}_transcripts.json``, and write ``{job_id}.error`` on failure
(:69-85). Exposed both as a function and a CLI::

    python -m expressive_speech_translation_tpu_torch.batch.runner INPUT OUT_DIR \
        --job-id JOB --lang fra [--manifest CSV --row $SLURM_ARRAY_TASK_ID]
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import traceback
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)


def run_batch_job(
    input_path: str | Path,
    output_dir: str | Path,
    *,
    job_id: str,
    target_lang: str = "fra",
    source_lang: str = "eng",
    backend=None,
    device=None,
) -> dict:
    """Process one file; never raises — failures produce ``{job_id}.error``
    (a missing card among them, unless ``device="cpu"``)."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    try:
        from ..media.wavio import read_wav, write_wav
        from ..pipeline.audio_processor import AudioProcessor

        if backend is None:
            from ..pipeline.cascaded import CascadedBackend
            from ..pipeline.engines import fake_engines

            backend = CascadedBackend(fake_engines())
        if not getattr(backend, "initialized", False):
            backend.initialize()
            backend.initialized = True

        suffix = Path(input_path).suffix.lower()
        if suffix == ".wav":
            audio, sr = read_wav(input_path)
        else:
            from ..media import decode_audio_bytes

            audio, sr = decode_audio_bytes(Path(input_path).read_bytes(), suffix)

        processed = AudioProcessor(device=device).process_audio(audio, orig_sr=sr)
        result = backend.translate_speech(processed, source_lang, target_lang)

        write_wav(out / f"{job_id}.wav", result["audio"][0], 16_000)
        (out / f"{job_id}_transcripts.json").write_text(
            json.dumps(result.get("transcripts", {}), ensure_ascii=False, indent=2)
        )
        log.info("job %s done", job_id)
        return {"job_id": job_id, "status": "ok"}
    except Exception as e:  # noqa: BLE001 — parity: .error file per failed job
        (out / f"{job_id}.error").write_text(
            f"{type(e).__name__}: {e}\n\n{traceback.format_exc()}"
        )
        log.exception("job %s failed", job_id)
        return {"job_id": job_id, "status": "error", "error": str(e)}


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input", nargs="?", help="input media file")
    parser.add_argument("output_dir")
    parser.add_argument("--job-id", default=None)
    parser.add_argument("--lang", default="fra", help="target language (app code)")
    parser.add_argument("--source-lang", default="eng")
    parser.add_argument("--manifest", help="manifest CSV (with --row)")
    parser.add_argument("--row", type=int, help="1-based manifest row (SLURM_ARRAY_TASK_ID)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; cpu to run without one)")
    args = parser.parse_args(argv)

    if args.manifest and args.row is not None:
        from .manifest import manifest_row

        row = manifest_row(args.manifest, args.row)
        input_path, job_id = row["path"], row["job_id"]
    else:
        if not args.input:
            parser.error("input file required when no --manifest/--row")
        input_path = args.input
        job_id = args.job_id or Path(args.input).stem

    result = run_batch_job(
        input_path, args.output_dir, job_id=job_id,
        target_lang=args.lang, source_lang=args.source_lang, device=args.device,
    )
    print(json.dumps(result))
    return 0 if result["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
