"""Typed, layered configuration: the port's copy of the JAX package's
``core/config.py``.

    dataclass defaults  <  YAML config file  <  environment variables  <  overrides

Environment variables use the ``EST_`` prefix with ``__`` as the section
separator, e.g. ``EST_SERVE__PORT=5001`` sets ``AppConfig.serve.port``. The
reference's historical names (``COSYVOICE_API_URL``,
``MAX_AUDIO_LENGTH_SECONDS``, ...) are honoured as aliases. The sections and
their fields are JAX's, so one YAML file or environment configures either
package. ``yaml`` is imported only when a file is read: the card's machine
has none, and ``load_config()`` without a file needs none.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any, Mapping, Optional, Tuple, Type, TypeVar

T = TypeVar("T")


class ConfigError(ValueError):
    """Raised for malformed config files, unknown keys, or bad env values."""


# --------------------------------------------------------------------------- sections


@dataclass(frozen=True)
class AudioConfig:
    """Audio frontend limits and DSP constants.

    Mirrors the reference's behavioural constants: 16 kHz pipeline rate and
    300 s / 3600 s / 150 MB input caps (Backend/app.py:181-184), the accepted
    upload formats (services/audio_processor.py:21-23), and the cloning-reference
    cap (services/cascaded_backend.py:376-385).
    """

    sample_rate: int = 16_000
    max_audio_seconds: float = 300.0
    max_podcast_seconds: float = 3600.0
    max_video_mb: float = 150.0
    # byte cap on audio uploads BEFORE the body is buffered/decoded (the
    # duration caps only run after a full read; sized to admit a 1 h
    # 44.1 kHz stereo PCM podcast while refusing multi-GB bodies)
    max_audio_upload_mb: float = 750.0
    max_url_media_seconds: float = 120.0
    clone_reference_seconds: float = 25.0
    target_lufs: float = -23.0
    allowed_formats: Tuple[str, ...] = (".wav", ".mp3", ".ogg", ".flac")
    # STFT used by the denoise path (audio_processor.py:333-344)
    denoise_n_fft: int = 1024
    denoise_hop: int = 256
    # Kaiser-window resample quality (audio_processor.py:297-304)
    resample_lowpass_filter_width: int = 128
    resample_kaiser_beta: float = 14.769656459379492
    resample_rolloff: float = 0.9475937167399596


@dataclass(frozen=True)
class ServiceEndpoints:
    """In-process stage registry endpoints.

    The reference spoke HTTP between containers (cascaded_backend.py:40-41,
    video_routes.py:26). Both packages run the stages in-process; these URLs
    remain for the optional remote-stage mode and for contract parity.
    """

    cosyvoice_url: str = "http://localhost:8002"
    musetalk_url: str = "http://localhost:8003"
    voice_similarity_url: str = "http://localhost:8001"
    openvoice_url: str = "http://localhost:8004"
    tts_timeout_seconds: float = 3600.0
    tts_warmup_timeout_seconds: float = 300.0
    lipsync_timeout_seconds: float = 7200.0
    health_retries: int = 5
    health_backoff_seconds: float = 10.0


@dataclass(frozen=True)
class ServeConfig:
    """HTTP facade settings (reference: Backend/app.py:209-254, :523)."""

    host: str = "0.0.0.0"
    port: int = 5001
    cors_origins: Tuple[str, ...] = (
        "http://localhost:3000",
        "http://localhost:3001",
    )
    # Flask-Limiter-equivalent rate limits (app.py:211, :254, :336, :401, :444)
    default_limits: Tuple[str, ...] = ("500 per day", "100 per hour")
    translate_limit: str = "20 per minute"
    video_limit: str = "10 per minute"
    audio_url_limit: str = "10 per minute"
    podcast_limit: str = "5 per minute"
    save_debug_audio: bool = False
    memory_threshold: float = 0.9  # services/resource_monitor.py:11
    # serving micro-batching (serve/batching.py) — coalesce concurrent TTS
    # requests into one device dispatch; reference serves 1 request/GPU pass
    tts_batching: bool = False
    tts_max_batch: int = 8
    tts_batch_wait_ms: float = 20.0
    # OIDC-style auth gate on the creator studio. The reference wires
    # react-oidc-context + a Cognito config at the app root but ships it
    # COMMENTED OUT (Frontend/src/index.js:5-21) — so the gate defaults to
    # disabled (authority "") and activates when an authority is configured
    # (EST_SERVE__AUTH_AUTHORITY / EST_SERVE__AUTH_CLIENT_ID).
    auth_authority: str = ""
    auth_client_id: str = ""
    auth_scope: str = "phone openid email"  # index.js cognitoAuthConfig.scope


@dataclass(frozen=True)
class EngineConfig:
    """Stage-engine construction for the server.

    ``mode`` keeps the JAX package's field and values: "jax" (the port's
    own engines, ``torch_engines``; random weights unless EST_MODELS_DIR or
    explicit params supply real ones), "fake" (deterministic test doubles) or
    "remote" (the split deployment: the port's ASR and NMT in-process, the
    TTS over HTTP from ``endpoints.cosyvoice_url``, ``serve/clients.py``);
    empty = the caller's default (``serve/app.py`` ``create_app``).
    """

    mode: str = ""                       # "" (auto) | "jax" | "fake" | "remote"
    scale: str = "reference"             # toy | reference (jax mode)
    quantize: bool = False               # weight-only int8 decode paths
    # Multi-token-prediction decode width for the TTS speech-LM. 0 = follow
    # the checkpoint (an SFT-exported LM with trained MTP heads serves K
    # tokens per backbone pass automatically); K>1 forces the width for
    # random-weight/bench runs; K=1 explicitly pins single-token decode
    # even on an MTP-capable checkpoint. Checkpoints without heads always
    # fall back to single-token decode. EST_ENGINES__TTS_MTP.
    tts_mtp: int = 0
    # Lossless speculative decode for B=1 TTS requests: MTP drafts are
    # VERIFIED against the true-context sampler (token-identical output to
    # single-token decoding) instead of accepted blindly. Needs MTP heads
    # (tts_mtp>1 or a trained checkpoint). EST_ENGINES__TTS_SPEC.
    tts_spec: bool = False
    # (30,) = exact whisper semantics (every chunk encodes the padded 30 s
    # window). Restricted-context buckets like (10, 20, 30) are a latency
    # trick with a documented accuracy cost (positional-embedding
    # distribution shift) — deployments opt in explicitly (ADVICE r2).
    asr_context_buckets: Tuple[int, ...] = (30,)
    # Stage-placement parallelism (parallel/stages.py): ASR/NMT/TTS params
    # on disjoint device groups of the slice, so threaded serving pipelines
    # concurrent requests across stages (the PP analog of SURVEY §2.19;
    # remainder chips go to TTS, the heaviest stage). stage_tp applies
    # tensor parallelism inside each group. EST_ENGINES__STAGE_PARALLEL.
    stage_parallel: bool = False
    stage_tp: int = 1


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout (the JAX package's sharding section; one file
    configures either package). ``coordinator`` / ``num_processes`` /
    ``process_id`` join hosts in ``parallel.mesh.maybe_initialize_distributed``.

    ``dp`` of -1 means "fill with all remaining devices"."""

    dp: int = -1
    tp: int = 1
    use_bf16: bool = True
    # multi-host wiring; empty/defaults = a single host
    coordinator: str = ""      # "<worker0-host>:<port>"
    num_processes: int = 0
    process_id: int = -1


@dataclass(frozen=True)
class TrainConfig:
    """SFT loop hyperparameters (reference: greek_sft.yaml:94-103, train_greek.sh)."""

    seed: int = 1986
    learning_rate: float = 1e-5
    scheduler: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 0     # required (> warmup_steps) for warmup_cosine
    max_epochs: int = 10
    grad_clip: float = 5.0
    accum_grad: int = 4
    save_per_step: int = 1000
    log_interval: int = 100
    max_frames_in_batch: int = 2000
    token_max_length: int = 200
    shuffle_buffer: int = 1000
    sort_buffer: int = 500
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 10
    # structured train/CV metrics JSONL (the reference writes TensorBoard
    # events from its executor; empty = log-lines only)
    metrics_path: str = ""
    # Multi-token-prediction width: train K-1 extra output heads alongside
    # the next-token head (train/sft.py adds their losses) so the exported
    # LM serves K speech tokens per backbone pass (EST_TRAIN__MTP / yaml
    # train.mtp). 1 = reference-exact single-token objective.
    mtp: int = 1


def _default_temp_dir() -> str:
    import tempfile

    return os.environ.get(
        "EST_TEMP_DIR",
        os.path.join(tempfile.gettempdir(), "est_runtime"))


@dataclass(frozen=True)
class AppConfig:
    """Root configuration object."""

    audio: AudioConfig = field(default_factory=AudioConfig)
    endpoints: ServiceEndpoints = field(default_factory=ServiceEndpoints)
    serve: ServeConfig = field(default_factory=ServeConfig)
    engines: EngineConfig = field(default_factory=EngineConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    default_backend: str = "cascaded"
    log_dir: str = "logs"
    # Per-request UUID dirs + podcast storage live under a RUNTIME path, not
    # the repo root (the reference nests its equivalent under Backend/ —
    # services/video_routes.py:36-39; EST_TEMP_DIR overrides).
    temp_dir: str = field(default_factory=lambda: _default_temp_dir())
    hf_token: Optional[str] = None


# Reference env-var names kept as aliases (Docker/.env.template, cascaded_backend.py).
_LEGACY_ENV_ALIASES: Mapping[str, str] = {
    "COSYVOICE_API_URL": "endpoints.cosyvoice_url",
    "MUSETALK_API_URL": "endpoints.musetalk_url",
    "VOICE_SIMILARITY_API_URL": "endpoints.voice_similarity_url",
    "OPENVOICE_API_URL": "endpoints.openvoice_url",
    "MAX_AUDIO_LENGTH_SECONDS": "audio.max_audio_seconds",
    "MAX_PODCAST_LENGTH_SECONDS": "audio.max_podcast_seconds",
    "MAX_VIDEO_MB": "audio.max_video_mb",
    "SAMPLE_RATE": "audio.sample_rate",
    "TARGET_LUFS": "audio.target_lufs",
    "SAVE_DEBUG_AUDIO_FILES": "serve.save_debug_audio",
    "MEMORY_THRESHOLD": "serve.memory_threshold",
    "HUGGINGFACE_TOKEN": "hf_token",
}

_ENV_PREFIX = "EST_"

# Documented EST_-prefixed env vars that are NOT config keys (asset mounts,
# bench knobs): load_config must skip them — previously EST_MODELS_DIR alone
# crashed every load_config() call at startup with "unknown config key".
_RUNTIME_ENV_VARS = frozenset({
    "EST_MODELS_DIR", "EST_TOKENIZER", "EST_SER_MODEL", "EST_COMPILE_CACHE",
    "EST_PLATFORM",  # the JAX package's platform pin for its CLI smoke runs
})


# ------------------------------------------------------------------- implementation


def _coerce(value: str, typ: Any) -> Any:
    """Coerce a string (env var / yaml scalar) to the annotated field type."""
    origin = getattr(typ, "__origin__", None)
    if typ is Any:
        return value
    if origin is not None:
        args = [a for a in typ.__args__ if a is not type(None)]  # Optional[X]
        if origin is tuple:
            items = [v.strip() for v in value.split(",") if v.strip()]
            elem = args[0] if args else str
            return tuple(_coerce(i, elem) for i in items)
        if len(args) == 1:
            return _coerce(value, args[0])
        raise ConfigError(f"cannot coerce {value!r} to {typ}")
    if typ is bool:
        lowered = value.strip().lower()
        if lowered in ("1", "true", "yes", "on"):
            return True
        if lowered in ("0", "false", "no", "off", ""):
            return False
        raise ConfigError(f"bad boolean {value!r}")
    if typ in (int, float, str):
        try:
            return typ(value)
        except ValueError as e:
            raise ConfigError(f"bad {typ.__name__} {value!r}") from e
    return value


def _replace_path(cfg: T, dotted: str, value: Any) -> T:
    """Return a copy of dataclass ``cfg`` with the dotted field path replaced."""
    head, _, rest = dotted.partition(".")
    match = {f.name: f for f in fields(cfg)}.get(head)
    if match is None:
        raise ConfigError(
            f"unknown config key {head!r} on {type(cfg).__name__} "
            f"(valid: {sorted(f.name for f in fields(cfg))})"
        )
    current = getattr(cfg, head)
    if rest:
        if not is_dataclass(current):
            raise ConfigError(f"{head!r} is a leaf, cannot descend into {rest!r}")
        new_value: Any = _replace_path(current, rest, value)
    else:
        new_value = _coerce(value, match.type) if isinstance(value, str) else value
        if isinstance(new_value, list):
            # YAML sequences arrive as lists; Tuple-annotated frozen fields
            # must hold tuples (hashability, tuple concatenation at callers)
            new_value = tuple(new_value)
        if is_dataclass(current) and isinstance(value, Mapping):
            new_value = _merge_mapping(current, value)
    return dataclasses.replace(cfg, **{head: new_value})


def _merge_mapping(cfg: T, data: Mapping[str, Any]) -> T:
    out = cfg
    for key, value in data.items():
        out = _replace_path(out, str(key), value)
    return out


def _resolve_types(cls: Type[Any]) -> None:
    """Materialize string annotations (from __future__ annotations) once."""
    resolved = dataclasses.fields(cls)
    hints = None
    for f in resolved:
        if isinstance(f.type, str):
            if hints is None:
                import typing

                hints = typing.get_type_hints(cls)
            f.type = hints[f.name]
        if is_dataclass(f.type):
            _resolve_types(f.type)


_resolve_types(AppConfig)


def load_config(
    path: Optional[str | Path] = None,
    env: Optional[Mapping[str, str]] = None,
    **overrides: Any,
) -> AppConfig:
    """Build an :class:`AppConfig` from defaults < YAML < env < overrides.

    ``overrides`` accepts dotted keys via ``load_config(**{"serve.port": 8080})``
    as well as plain section names with mapping values.
    """
    cfg = AppConfig()

    if path is not None:
        import yaml

        raw = yaml.safe_load(Path(path).read_text()) or {}
        if not isinstance(raw, Mapping):
            raise ConfigError(f"config file {path} must contain a mapping")
        cfg = _merge_mapping(cfg, raw)

    env = os.environ if env is None else env
    # empty values count as unset: compose files export `${VAR:-}` defaults,
    # which reach the process as "" — those must not override (or crash on
    # non-string fields)
    for name, dotted in _LEGACY_ENV_ALIASES.items():
        if env.get(name, "") != "":
            cfg = _replace_path(cfg, dotted, env[name])
    for name, value in env.items():
        if name.startswith(_ENV_PREFIX) and name not in _RUNTIME_ENV_VARS \
                and not name.startswith("EST_BENCH_") and value != "":
            dotted = name[len(_ENV_PREFIX):].lower().replace("__", ".")
            cfg = _replace_path(cfg, dotted, value)

    for dotted, value in overrides.items():
        cfg = _replace_path(cfg, dotted, value)
    return cfg


def to_dict(cfg: Any) -> dict:
    """Dataclass → plain nested dict (for logging / checkpoint metadata)."""
    return dataclasses.asdict(cfg)
