"""Podcast upload persistence (the JAX package's ``serve/podcasts.py``).

Each upload is saved as ``{uuid}_{secure_filename}`` under the store's root
with a ``{uuid}.meta.json`` sidecar: title, episode number (the count of
episodes stored), mm:ss duration and the path. The store lists, reads and
serves uploads back, and survives a restart; sidecars of the older
``{id}_{fname}.json`` scheme stay readable.
"""

from __future__ import annotations

import datetime as _dt
import json
import re
import threading
import uuid
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..core.errors import ValidationError


def secure_filename(name: str) -> str:
    """werkzeug's ``secure_filename`` in effect: the path's directories and
    every character outside [A-Za-z0-9._-] dropped."""
    name = Path(name).name
    name = re.sub(r"[^A-Za-z0-9._-]", "_", name).strip("._")
    return name or "upload"


class PodcastStore:
    def __init__(self, root: str | Path):
        self.root = Path(root).absolute()
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()

    def save(self, raw: bytes, filename: str, *, title: Optional[str] = None,
             duration_seconds: float = 0.0, sample_rate: int = 0) -> Dict:
        unique_id = uuid.uuid4().hex
        fname = secure_filename(filename)
        path = self.root / f"{unique_id}_{fname}"
        minutes, seconds = int(duration_seconds // 60), int(duration_seconds % 60)
        with self._lock:
            path.write_bytes(raw)
            # the sidecar is named from the id alone ({id}.meta.json), so an
            # upload whose name ends in .json never collides with it: audio
            # files always carry the joining underscore, sidecars never
            meta = {
                "id": unique_id,
                "podcast_id": unique_id,
                "title": title or Path(fname).stem,
                "filename": fname,
                # the episode number counts what list() shows, so legacy
                # sidecars do not collide with new numbers
                "episode": str(sum(1 for _ in self._sidecars()) + 1),
                "duration": f"{minutes:02d}:{seconds:02d}",
                "duration_seconds": round(duration_seconds, 2),
                "sample_rate": sample_rate,
                "date": _dt.datetime.now().isoformat(),
                "filepath": str(path),
            }
            (self.root / f"{unique_id}.meta.json").write_text(
                json.dumps(meta), encoding="utf-8")
        return meta

    _LEGACY_SIDECAR = re.compile(r"[0-9a-f]{32}_.+\.json$")

    def _sidecars(self):
        """Sidecars of the current scheme, then legacy ``{id}_{fname}.json``
        ones: those need the 32-hex id prefix and their audio file
        ``{id}_{fname}`` beside them, so an audio upload whose name ends in
        ``.json`` is never read as metadata."""
        for sidecar in sorted(self.root.glob("*.meta.json")):
            yield sidecar
        for sidecar in sorted(self.root.glob("*_*.json")):
            if sidecar.name.endswith(".meta.json"):
                continue
            if not self._LEGACY_SIDECAR.fullmatch(sidecar.name):
                continue
            if not Path(str(sidecar)[: -len(".json")]).exists():
                continue
            yield sidecar

    def list(self) -> List[Dict]:
        out = []
        for sidecar in self._sidecars():
            try:
                out.append(json.loads(sidecar.read_text(encoding="utf-8")))
            except (OSError, ValueError):
                continue
        return out

    def get(self, podcast_id: str) -> Tuple[Dict, Path]:
        if not re.fullmatch(r"[0-9a-f]{32}", podcast_id or ""):
            raise ValidationError("invalid podcast id")
        sidecar = self.root / f"{podcast_id}.meta.json"
        if not sidecar.exists():
            # legacy scheme: {id}_{fname}.json next to {id}_{fname}
            legacy = [p for p in self.root.glob(f"{podcast_id}_*.json")
                      if not p.name.endswith(".meta.json")]
            for cand in legacy:
                try:
                    meta = json.loads(cand.read_text(encoding="utf-8"))
                except (OSError, ValueError):
                    continue
                audio_path = Path(str(cand)[: -len(".json")])
                if audio_path.exists():
                    return meta, audio_path
            raise ValidationError(f"unknown podcast id {podcast_id}")
        meta = json.loads(sidecar.read_text(encoding="utf-8"))
        audio_path = self.root / f"{podcast_id}_{meta['filename']}"
        if not audio_path.exists():
            raise ValidationError(f"podcast {podcast_id} audio missing")
        return meta, audio_path
