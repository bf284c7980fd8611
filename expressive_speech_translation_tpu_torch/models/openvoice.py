"""OpenVoice v2 tone-colour converter.

The port of the JAX package's ``models/openvoice.py``, the model behind the
reference's OpenVoice service (Docker/openvoice_api.py:39-288): 256-d
speaker embeddings ("SE") and ``/clone-voice``, which moves a source
utterance's timbre toward a target SE and keeps its content and prosody, at
22 050 Hz. The VITS ``SynthesizerTrn`` voice-conversion subset, at the
published converter's widths by default (inter/hidden 192, gin 256, zero_g,
HiFi-GAN (8, 8, 2, 2) at 512, resblocks (3, 7, 11) × (1, 3, 5)):

- PosteriorEncoder: 1×1 pre-conv → 16-layer gated WaveNet (kernel 5,
  dilation 1, SE conditioning through one shared cond projection) → 1×1
  proj to (mean, log σ); z = m + ε·exp(log σ)·τ, the mean alone when no ε
  is given (the JAX package's deterministic mode, ε = 0);
- ResidualCouplingBlock: 4 mean-only coupling layers (4-layer WN each,
  SE-conditioned) with channel flips, exactly invertible;
- the HiFi-GAN generator: conv_pre 7 → 4 transposed-conv upsamples →
  ResBlock1 banks (leaky 0.1) → conv_post 7 (no bias) → tanh;
- ReferenceEncoder: six 3×3 stride-2 2-D convs over the spectrogram → a GRU
  (torch's gate order r|z|n) → linear → the 256-d SE.

Conversion with zero_g: the posterior and the decoder see zero conditioning;
only the flow carries speaker identity: z = enc(spec); z_p = flow(z | se_src);
ẑ = flow⁻¹(z_p | se_tgt); ŷ = dec(ẑ).

The public functions take the JAX package's layouts (spectrograms
[B, T, n_spec], latents [B, T, C], waveforms [B, N]); inside, activations run
as [B, C, T] through ``F.conv1d`` / ``F.conv_transpose1d`` / ``F.conv2d``.
Kernels are stored as torch stores them: conv [out, in, k], transposed conv
[in, out, k] (torch's own padding, so no flip), 2-D conv [out, in, kh, kw];
dense kernels [in, out]. The JAX package runs this model in plain XLA, with
no Pallas kernel on its path, so the port launches none of its kernels here.
Converters: :func:`from_openvoice_state_dict` (a ``checkpoint.pth``) and
:func:`from_jax_params` (the JAX package's tree).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..ops.stft import reflect_pad, stft
from .common import Init, Params, dense, permute_conv_kernels, tree_from_numpy


@dataclasses.dataclass(frozen=True)
class OpenVoiceConfig:
    # data (config.json "data")
    sample_rate: int = 22_050
    n_fft: int = 1024
    hop: int = 256
    # model (config.json "model")
    n_spec: int = 513
    inter_channels: int = 192
    hidden: int = 192
    se_dim: int = 256              # gin_channels
    zero_g: bool = True
    n_flows: int = 4
    flow_wn_layers: int = 4
    post_wn_layers: int = 16
    wn_kernel: int = 5
    resblock_kernels: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernels: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial: int = 512
    ref_filters: Tuple[int, ...] = (32, 32, 64, 64, 128, 128)
    tau: float = 0.3               # openvoice_api convert(tau=0.3)


# ------------------------------------------------------------------ primitives


def _init_conv1d(r: Init, width: int, in_ch: int, out_ch: int, *, bias: bool = True) -> Params:
    p = {"kernel": r.uniform((out_ch, in_ch, width), 1.0 / np.sqrt(in_ch * width))}
    if bias:
        p["bias"] = r.zeros((out_ch,))
    return p


def _conv1d(p: Params, x: torch.Tensor, *, dilation: int = 1) -> torch.Tensor:
    """"Same" conv over [B, C, T]: dilation·(width − 1)//2 each side."""
    k = p["kernel"]
    return F.conv1d(x.to(k.dtype), k, p.get("bias"), padding=dilation * (k.shape[-1] - 1) // 2,
                    dilation=dilation)


def _conv_transpose1d(p: Params, x: torch.Tensor, *, stride: int, torch_pad: int) -> torch.Tensor:
    """torch's ConvTranspose1d(stride, padding=torch_pad): T·stride samples
    for (k − stride)//2 padding. The JAX package reaches the same function
    as an input-dilated conv with k − 1 − torch_pad edges and the kernel
    flipped."""
    k = p["kernel"]
    return F.conv_transpose1d(x.to(k.dtype), k, p["bias"], stride=stride, padding=torch_pad)


def _init_conv2d(r: Init, width: int, in_ch: int, out_ch: int) -> Params:
    return {"kernel": r.uniform((out_ch, in_ch, width, width),
                                1.0 / np.sqrt(in_ch * width * width)),
            "bias": r.zeros((out_ch,))}


def _conv2d_s2(p: Params, x: torch.Tensor) -> torch.Tensor:
    """3×3 stride-2 pad-1 conv over [B, C, T, F] (the ReferenceEncoder stack)."""
    k = p["kernel"]
    return F.conv2d(x.to(k.dtype), k, p["bias"], stride=2, padding=1)


# ----------------------------------------------------------------- WaveNet WN


def _init_wn(r: Init, cfg: OpenVoiceConfig, n_layers: int) -> Params:
    """VITS modules.WN: gated tanh units, one shared cond projection (a 1×1
    conv gin → 2·h·n_layers), residual + skip 1×1 convs (skip only last)."""
    h = cfg.hidden
    return {
        "cond": _init_conv1d(r, 1, cfg.se_dim, 2 * h * n_layers),
        "in": [_init_conv1d(r, cfg.wn_kernel, h, 2 * h) for _ in range(n_layers)],
        "res_skip": [_init_conv1d(r, 1, h, 2 * h if i < n_layers - 1 else h)
                     for i in range(n_layers)],
    }


def _wn(p: Params, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x [B, h, T], g [B, se_dim] → [B, h, T] (modules.WN.forward, dilation 1)."""
    h = x.shape[1]
    cond = _conv1d(p["cond"], g[:, :, None])      # [B, 2h·L, 1]
    out = torch.zeros_like(x)
    n_layers = len(p["in"])
    for i in range(n_layers):
        z = _conv1d(p["in"][i], x) + cond[:, 2 * h * i: 2 * h * (i + 1)]
        acts = torch.tanh(z[:, :h]) * torch.sigmoid(z[:, h:])
        rs = _conv1d(p["res_skip"][i], acts)
        if i < n_layers - 1:
            x = x + rs[:, :h]
            out = out + rs[:, h:]
        else:
            out = out + rs
    return out


# ---------------------------------------------------------- posterior encoder


def _init_posterior(r: Init, cfg: OpenVoiceConfig) -> Params:
    return {"pre": _init_conv1d(r, 1, cfg.n_spec, cfg.hidden),
            "wn": _init_wn(r, cfg, cfg.post_wn_layers),
            "proj": _init_conv1d(r, 1, cfg.hidden, 2 * cfg.inter_channels)}


def posterior_encode(params: Params, cfg: OpenVoiceConfig, spec: torch.Tensor, g: torch.Tensor,
                     *, tau: float = 0.0, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """spec [B, T, n_spec] → z [B, T, inter] (models.py PosteriorEncoder:
    m + ε·σ·τ). ``eps`` is the standard-normal draw [B, T, inter]; with none,
    or τ = 0, z is the mean (the JAX package's mode without a key)."""
    h = _conv1d(params["pre"], spec.transpose(1, 2))
    h = _wn(params["wn"], h, g)
    m, logs = _conv1d(params["proj"], h).chunk(2, dim=1)
    m, logs = m.transpose(1, 2), logs.transpose(1, 2)
    if eps is None or tau == 0.0:
        return m
    return m + eps.to(m.dtype) * torch.exp(logs) * tau


# ------------------------------------------------------------------------ flow


def _init_coupling(r: Init, cfg: OpenVoiceConfig) -> Params:
    half = cfg.inter_channels // 2
    return {"pre": _init_conv1d(r, 1, half, cfg.hidden),
            "wn": _init_wn(r, cfg, cfg.flow_wn_layers),
            # post is zero-initialised in VITS (the flow is the identity at init)
            "post": {"kernel": r.zeros((half, cfg.hidden, 1)), "bias": r.zeros((half,))}}


def _coupling_mean(p: Params, x0: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return _conv1d(p["post"], _wn(p["wn"], _conv1d(p["pre"], x0), g))


def flow_forward(params: Params, cfg: OpenVoiceConfig, z: torch.Tensor,
                 se: torch.Tensor) -> torch.Tensor:
    """Mean-only residual coupling (+ a channel flip a layer), exactly
    invertible; z [B, T, inter], the conditioning carries the speaker."""
    x = z.transpose(1, 2)
    for layer in params["flow"]:
        x0, x1 = x.chunk(2, dim=1)
        x = torch.flip(torch.cat([x0, x1 + _coupling_mean(layer, x0, se)], dim=1), [1])
    return x.transpose(1, 2)


def flow_inverse(params: Params, cfg: OpenVoiceConfig, z: torch.Tensor,
                 se: torch.Tensor) -> torch.Tensor:
    x = z.transpose(1, 2)
    for layer in reversed(params["flow"]):
        x0, x1 = torch.flip(x, [1]).chunk(2, dim=1)
        x = torch.cat([x0, x1 - _coupling_mean(layer, x0, se)], dim=1)
    return x.transpose(1, 2)


# ------------------------------------------------------------ HiFi-GAN decoder


def _init_generator(r: Init, cfg: OpenVoiceConfig) -> Params:
    u0 = cfg.upsample_initial
    p: Dict[str, Any] = {"conv_pre": _init_conv1d(r, 7, cfg.inter_channels, u0),
                         "cond": _init_conv1d(r, 1, cfg.se_dim, u0),
                         "ups": [], "resblocks": []}
    ch = u0
    for k in cfg.upsample_kernels:
        scale = 1.0 / np.sqrt(ch * k)
        p["ups"].append({"kernel": r.uniform((ch, ch // 2, k), scale),
                         "bias": r.zeros((ch // 2,))})
        ch //= 2
        for kr, dils in zip(cfg.resblock_kernels, cfg.resblock_dilations):
            p["resblocks"].append({"convs1": [_init_conv1d(r, kr, ch, ch) for _ in dils],
                                   "convs2": [_init_conv1d(r, kr, ch, ch) for _ in dils]})
    p["conv_post"] = _init_conv1d(r, 7, ch, 1, bias=False)
    return p


def _resblock1(p: Params, x: torch.Tensor, dils) -> torch.Tensor:
    """HiFi-GAN ResBlock1: (lrelu → dilated conv → lrelu → conv) ×3, residual."""
    for c1, c2, d in zip(p["convs1"], p["convs2"], dils):
        xt = _conv1d(c1, F.leaky_relu(x, 0.1), dilation=d)
        x = x + _conv1d(c2, F.leaky_relu(xt, 0.1))
    return x


def generator_decode(params: Params, cfg: OpenVoiceConfig, z: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """z [B, T, inter] + SE [B, se_dim] → waveform [B, T·prod(rates)]."""
    x = _conv1d(params["conv_pre"], z.transpose(1, 2))
    x = x + _conv1d(params["cond"], g[:, :, None])
    n_k = len(cfg.resblock_kernels)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernels)):
        x = _conv_transpose1d(params["ups"][i], F.leaky_relu(x, 0.1), stride=u,
                              torch_pad=(k - u) // 2)
        acc = None
        for j, dils in enumerate(cfg.resblock_dilations):
            y = _resblock1(params["resblocks"][i * n_k + j], x, dils)
            acc = y if acc is None else acc + y
        x = acc / n_k
    x = _conv1d(params["conv_post"], F.leaky_relu(x))    # default slope 0.01
    return torch.tanh(x)[:, 0]


# --------------------------------------------------------- reference encoder


def _ref_freq_bins(cfg: OpenVoiceConfig) -> int:
    """The frequency size after the stride-2 convs."""
    f = cfg.n_spec
    for _ in cfg.ref_filters:
        f = (f - 1) // 2 + 1
    return f


def _init_ref_encoder(r: Init, cfg: OpenVoiceConfig) -> Params:
    filters = (1,) + cfg.ref_filters
    gru_h = cfg.se_dim // 2
    return {"convs": [_init_conv2d(r, 3, filters[i], filters[i + 1])
                      for i in range(len(cfg.ref_filters))],
            "gru": {"wi": r.dense(cfg.ref_filters[-1] * _ref_freq_bins(cfg), 3 * gru_h),
                    "wh": r.dense(gru_h, 3 * gru_h)},
            "proj": r.dense(gru_h, cfg.se_dim)}


def _gru(p: Params, x: torch.Tensor) -> torch.Tensor:
    """torch's nn.GRU (one layer, batch first) step by step, as the JAX
    package's ``lax.scan``: the final hidden state [B, H]. Gate order r|z|n,
    torch's weight layout; the reset gate scales the hidden product, bias
    included."""
    h_dim = p["wh"]["kernel"].shape[0]
    xw = dense(p["wi"], x)                           # [B, T, 3H]
    h = torch.zeros(x.shape[0], h_dim, dtype=x.dtype, device=x.device)
    for t in range(xw.shape[1]):
        xt, hw = xw[:, t], dense(p["wh"], h)
        r = torch.sigmoid(xt[:, :h_dim] + hw[:, :h_dim])
        z = torch.sigmoid(xt[:, h_dim:2 * h_dim] + hw[:, h_dim:2 * h_dim])
        n = torch.tanh(xt[:, 2 * h_dim:] + r * hw[:, 2 * h_dim:])
        h = (1 - z) * n + z * h
    return h


def extract_se(params: Params, cfg: OpenVoiceConfig, spec: torch.Tensor) -> torch.Tensor:
    """Speaker embedding of a spectrogram [B, T, n_spec] → [B, se_dim]
    (models.py ReferenceEncoder: 6 stride-2 convs → GRU → linear)."""
    x = spec[:, None]                                # [B, 1, T, F]
    for conv in params["ref_enc"]["convs"]:
        x = F.relu(_conv2d_s2(conv, x))
    b, c, t, f = x.shape
    # torch flattens [N, T', C, F'] channel-major: the GRU's input order is (c, f)
    x = x.transpose(1, 2).reshape(b, t, c * f)
    return dense(params["ref_enc"]["proj"], _gru(params["ref_enc"]["gru"], x))


# ------------------------------------------------------------------ public API


def init_openvoice(seed: int, cfg: OpenVoiceConfig = OpenVoiceConfig(), device=None) -> Params:
    """Seeded random parameters (f32) on ``device`` (the card unless
    ``device="cpu"``); the JAX package's tree structure, torch's numbers."""
    r = Init(seed, resolve_device(device))
    return {"enc_q": _init_posterior(r, cfg),
            "flow": [_init_coupling(r, cfg) for _ in range(cfg.n_flows)],
            "dec": _init_generator(r, cfg),
            "ref_enc": _init_ref_encoder(r, cfg)}


def spectrogram_22k(audio: torch.Tensor, cfg: OpenVoiceConfig = OpenVoiceConfig()) -> torch.Tensor:
    """VITS spectrogram_torch: reflect pad (n_fft − hop)/2, ``center=False``,
    hann, magnitude √(re² + im² + 1e-6). [B, T] → [B, frames, n_spec]."""
    x = reflect_pad(audio, (cfg.n_fft - cfg.hop) // 2)
    real, imag = stft(x, cfg.n_fft, cfg.hop, center=False)
    return torch.sqrt(real * real + imag * imag + 1e-6)


def convert_tone(params: Params, cfg: OpenVoiceConfig, source_audio_22k: torch.Tensor,
                 se_source: torch.Tensor, se_target: torch.Tensor, *,
                 tau: Optional[float] = None, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Timbre conversion at 22 050 Hz (models.py voice_conversion,
    openvoice_api.py:141-155): source [B, T] → [B, frames·hop]. With zero_g
    the posterior and the decoder take zero conditioning and identity flows
    through the coupling layers alone. ``eps`` is the posterior's draw
    (:func:`posterior_encode`); without it the posterior's mean is used."""
    spec = spectrogram_22k(source_audio_22k, cfg)
    zeros = torch.zeros_like(se_source)
    g_enc = zeros if cfg.zero_g else se_source
    g_dec = zeros if cfg.zero_g else se_target
    z = posterior_encode(params["enc_q"], cfg, spec, g_enc,
                         tau=cfg.tau if tau is None else tau, eps=eps)
    z_p = flow_forward(params, cfg, z, se_source)
    z_hat = flow_inverse(params, cfg, z_p, se_target)
    return generator_decode(params["dec"], cfg, z_hat, g_dec)


# ------------------------------------------------------------------ converters


def from_jax_params(tree, device, dtype=torch.float32) -> Params:
    """The JAX package's OpenVoice tree → the port's: conv kernels
    [width, in, out] → [out, in, width]; the ``ups`` kernels, stored
    flipped as [k, in, out], → torch's [in, out, k] unflipped; 2-D conv
    kernels [kh, kw, in, out] → [out, in, kh, kw]; dense kernels as they are."""
    p = tree_from_numpy(tree, device, dtype)
    ups = p["dec"].pop("ups")
    permute_conv_kernels(p, (2, 1, 0))
    p["dec"]["ups"] = [{"kernel": u["kernel"].permute(1, 2, 0).flip(-1).contiguous(),
                        "bias": u["bias"]} for u in ups]
    for conv in p["ref_enc"]["convs"]:
        conv["kernel"] = conv["kernel"].permute(3, 2, 0, 1).contiguous()
    return p


def _host(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        w = w.detach().to(torch.float32).cpu().numpy()
    return np.asarray(w, np.float32)


def _resolve_wn_weight(sd, prefix) -> np.ndarray:
    """weight_norm(conv).weight = g · v/‖v‖ (the norm over all axes but the
    first), in numpy f32 as the JAX package's converter folds it."""
    if f"{prefix}.weight" in sd:
        return _host(sd[f"{prefix}.weight"])
    g = _host(sd[f"{prefix}.weight_g"])
    v = _host(sd[f"{prefix}.weight_v"])
    norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def from_openvoice_state_dict(sd: Dict[str, Any], cfg: OpenVoiceConfig, device=None) -> Params:
    """An OpenVoice v2 converter checkpoint (``checkpoint.pth``'s ``model``
    tree, SynthesizerTrn naming, or that tree itself) → the port's params
    (f32) on ``device``. Weight norm is folded; the flow keeps the even
    entries (the odd ones are parameter-free Flips)."""
    dev = resolve_device(device)
    sd = dict(sd)
    if "model" in sd and not hasattr(sd["model"], "shape"):
        sd = sd["model"]

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def conv(prefix, *, bias=True) -> Params:
        p = {"kernel": t(_resolve_wn_weight(sd, prefix))}   # torch's own layout
        if bias and f"{prefix}.bias" in sd:
            p["bias"] = t(_host(sd[f"{prefix}.bias"]))
        return p

    def linear(prefix_w, prefix_b) -> Params:
        return {"kernel": t(_host(sd[prefix_w]).T), "bias": t(_host(sd[prefix_b]))}

    def wn(prefix, n_layers) -> Params:
        return {"cond": conv(f"{prefix}.cond_layer"),
                "in": [conv(f"{prefix}.in_layers.{i}") for i in range(n_layers)],
                "res_skip": [conv(f"{prefix}.res_skip_layers.{i}") for i in range(n_layers)]}

    n_k = len(cfg.resblock_kernels)
    return {
        "enc_q": {"pre": conv("enc_q.pre"), "wn": wn("enc_q.enc", cfg.post_wn_layers),
                  "proj": conv("enc_q.proj")},
        "flow": [{"pre": conv(f"flow.flows.{i}.pre"),
                  "wn": wn(f"flow.flows.{i}.enc", cfg.flow_wn_layers),
                  "post": conv(f"flow.flows.{i}.post")}
                 for i in range(0, 2 * cfg.n_flows, 2)],      # VITS stores [coupling, Flip]×n
        "dec": {
            "conv_pre": conv("dec.conv_pre"),
            "cond": conv("dec.cond"),
            "ups": [conv(f"dec.ups.{i}") for i in range(len(cfg.upsample_rates))],
            "resblocks": [
                {"convs1": [conv(f"dec.resblocks.{r}.convs1.{j}")
                            for j in range(len(cfg.resblock_dilations[r % n_k]))],
                 "convs2": [conv(f"dec.resblocks.{r}.convs2.{j}")
                            for j in range(len(cfg.resblock_dilations[r % n_k]))]}
                for r in range(len(cfg.upsample_rates) * n_k)],
            "conv_post": conv("dec.conv_post", bias=False),
        },
        "ref_enc": {
            "convs": [conv(f"ref_enc.convs.{i}") for i in range(len(cfg.ref_filters))],
            "gru": {"wi": linear("ref_enc.gru.weight_ih_l0", "ref_enc.gru.bias_ih_l0"),
                    "wh": linear("ref_enc.gru.weight_hh_l0", "ref_enc.gru.bias_hh_l0")},
            "proj": linear("ref_enc.proj.weight", "ref_enc.proj.bias"),
        },
    }
