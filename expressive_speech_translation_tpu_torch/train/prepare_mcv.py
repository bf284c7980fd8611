"""Mozilla Common Voice → Kaldi-style data prep.

Parity with prepare_mcv_data.py (70 LoC): read an MCV ``.tsv`` (columns
``path``, ``sentence``), emit ``wav.scp`` / ``text`` / ``utt2spk`` with a
single synthetic speaker id, container-style clip paths (:32-58).

CLI: python -m expressive_speech_translation_tpu_torch.train.prepare_mcv \
        validated.tsv out_dir --clips-root /data/el/clips --speaker spk001
"""

from __future__ import annotations

import argparse
import csv
import sys
from pathlib import Path
from typing import List, Tuple


def prepare_mcv(
    tsv_path: str | Path,
    out_dir: str | Path,
    *,
    clips_root: str = "/data/el/clips",
    speaker: str = "spk001",
    max_utts: int = 0,
) -> List[Tuple[str, str, str]]:
    """Returns the (utt_id, wav_path, sentence) rows written."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rows: List[Tuple[str, str, str]] = []
    with Path(tsv_path).open(newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f, delimiter="\t")
        for i, rec in enumerate(reader):
            if max_utts and len(rows) >= max_utts:
                break
            path = (rec.get("path") or "").strip()
            sentence = (rec.get("sentence") or "").strip()
            if not path or not sentence:
                continue
            utt_id = f"{speaker}_{Path(path).stem}"
            rows.append((utt_id, f"{clips_root.rstrip('/')}/{path}", sentence))

    with (out / "wav.scp").open("w", encoding="utf-8") as f:
        for utt, wav, _ in rows:
            f.write(f"{utt} {wav}\n")
    with (out / "text").open("w", encoding="utf-8") as f:
        for utt, _, sentence in rows:
            f.write(f"{utt} {sentence}\n")
    with (out / "utt2spk").open("w", encoding="utf-8") as f:
        for utt, _, _ in rows:
            f.write(f"{utt} {speaker}\n")
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("tsv")
    parser.add_argument("out_dir")
    parser.add_argument("--clips-root", default="/data/el/clips")
    parser.add_argument("--speaker", default="spk001")
    parser.add_argument("--max-utts", type=int, default=0)
    args = parser.parse_args(argv)
    rows = prepare_mcv(args.tsv, args.out_dir, clips_root=args.clips_root,
                       speaker=args.speaker, max_utts=args.max_utts)
    print(f"wrote {len(rows)} utterances to {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
