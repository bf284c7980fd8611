"""Guided diffusion: DDPM/DDIM sampling, respacing, schedule resampling, EMA.

The port of the JAX package's ``models/diffusion.py``, the guided-diffusion
core that diff2lip samples with (``pipeline/diff2lip.py``):

- beta schedules and respacing (``space_timesteps``): every table is built
  in float64 numpy, as JAX builds it, and read in f32 where a step gathers
  it (:meth:`GaussianDiffusion._gather`);
- q / posterior math, ``p_mean_variance`` (clipped x_0, fixed-small or
  fixed-large variance), the ancestral DDPM loop and the DDIM loop;
- the eps MSE loss, the uniform and loss-second-moment timestep samplers,
  the timestep embedding and the EMA update.

The sampling loops run their steps in Python (JAX's is one ``fori_loop``)
and keep their arithmetic in f32 whatever the model's output dtype, as
JAX's promotion keeps it. Randomness is explicit: the loops take their start
``x_init`` and per-step noise ``step_noise`` when they are given, and draw
them from a ``torch.Generator`` when not.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device

# -------------------------------------------------------------- beta schedules


def linear_betas(steps: int, *, start: float = 1e-4, end: float = 0.02) -> np.ndarray:
    scale = 1000.0 / steps  # guided-diffusion scales to the 1000-step reference
    # clamp: the scaled-linear convention exceeds 1.0 for very small step counts
    return np.clip(np.linspace(scale * start, scale * end, steps, dtype=np.float64), 1e-8, 0.999)


def cosine_betas(steps: int, *, max_beta: float = 0.999) -> np.ndarray:
    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    return np.asarray([min(1 - alpha_bar((i + 1) / steps) / alpha_bar(i / steps), max_beta)
                       for i in range(steps)], np.float64)


def named_beta_schedule(name: str, steps: int) -> np.ndarray:
    if name == "linear":
        return linear_betas(steps)
    if name == "cosine":
        return cosine_betas(steps)
    raise ValueError(f"unknown beta schedule {name!r}")


# ------------------------------------------------------------------ respacing


def space_timesteps(num_timesteps: int, section_counts: str | Sequence[int]) -> Set[int]:
    """guided_diffusion.respace.space_timesteps: ``"ddimN"`` (the integer
    stride giving exactly N steps) or per-section counts → the retained
    original-timestep indices."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[4:])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(f"cannot create exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start = 0
    taken: Set[int] = set()
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if count > size:
            raise ValueError(f"cannot take {count} steps from a section of {size}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            taken.add(start + round(cur))
            cur += stride
        start += size
    return taken


# ---------------------------------------------------------------- diffusion


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    steps: int = 1000
    schedule: str = "linear"
    # model output: 'epsilon' (noise prediction) or 'x_start'
    predict: str = "epsilon"
    # variance: 'fixed_small' | 'fixed_large'
    var_type: str = "fixed_small"
    clip_denoised: bool = True


class GaussianDiffusion:
    """All-precomputed diffusion math (gaussian_diffusion.py's)."""

    def __init__(self, cfg: DiffusionConfig = DiffusionConfig(),
                 *, use_timesteps: Optional[Set[int]] = None):
        self.cfg = cfg
        betas = named_beta_schedule(cfg.schedule, cfg.steps)

        # respacing (respace.py SpacedDiffusion): keep a subset, recompute betas
        self.timestep_map: Optional[np.ndarray] = None
        if use_timesteps is not None:
            alphas_cum = np.cumprod(1.0 - betas)
            last = 1.0
            new_betas, tmap = [], []
            for i, ac in enumerate(alphas_cum):
                if i in use_timesteps:
                    new_betas.append(1 - ac / last)
                    last = ac
                    tmap.append(i)
            betas = np.asarray(new_betas)
            self.timestep_map = np.asarray(tmap, np.int32)

        self.num_timesteps = len(betas)
        alphas = 1.0 - betas
        self.betas = betas
        self.alphas_cumprod = np.cumprod(alphas)
        self.alphas_cumprod_prev = np.append(1.0, self.alphas_cumprod[:-1])
        self.sqrt_alphas_cumprod = np.sqrt(self.alphas_cumprod)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - self.alphas_cumprod)
        self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod)
        self.sqrt_recipm1_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod - 1.0)
        self.posterior_variance = (
            betas * (1.0 - self.alphas_cumprod_prev) / (1.0 - self.alphas_cumprod))
        self.posterior_log_variance_clipped = np.log(
            np.append(self.posterior_variance[1], self.posterior_variance[1:]))
        self.posterior_mean_coef1 = (
            betas * np.sqrt(self.alphas_cumprod_prev) / (1.0 - self.alphas_cumprod))
        self.posterior_mean_coef2 = (
            (1.0 - self.alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - self.alphas_cumprod))
        self.log_betas = np.log(np.maximum(self.betas, 1e-20))   # the fixed_large variance
        self._on_device: Dict[str, Dict[str, torch.Tensor]] = {}

    # ------------------------------------------------------------- utilities

    _TABLES = ("timestep_map", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
               "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
               "sqrt_recipm1_alphas_cumprod", "posterior_log_variance_clipped",
               "posterior_mean_coef1", "posterior_mean_coef2", "log_betas")

    def _gather(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """The table ``name`` at ``t``, in f32 on t's device, shaped [B, 1, …]
        to broadcast over an ``ndim``-rank sample. A device gets every table
        at its first gather."""
        tables = self._on_device.get(str(t.device))
        if tables is None:
            tables = self._on_device[str(t.device)] = {
                n: torch.as_tensor(np.asarray(getattr(self, n), np.float32), device=t.device)
                for n in self._TABLES if getattr(self, n) is not None}
        out = tables[name][t]
        return out.reshape(out.shape + (1,) * (ndim - out.ndim))

    def model_t(self, t: torch.Tensor) -> torch.Tensor:
        """Map a respaced index to the original timestep fed to the model."""
        if self.timestep_map is None:
            return t
        return self._gather("timestep_map", t, 1).to(torch.long)

    # ------------------------------------------------------------ forward q()

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return (self._gather("sqrt_alphas_cumprod", t, x_start.ndim) * x_start
                + self._gather("sqrt_one_minus_alphas_cumprod", t, x_start.ndim) * noise)

    def predict_xstart_from_eps(self, x_t, t, eps):
        return (self._gather("sqrt_recip_alphas_cumprod", t, x_t.ndim) * x_t
                - self._gather("sqrt_recipm1_alphas_cumprod", t, x_t.ndim) * eps)

    def q_posterior_mean(self, x_start, x_t, t):
        return (self._gather("posterior_mean_coef1", t, x_t.ndim) * x_start
                + self._gather("posterior_mean_coef2", t, x_t.ndim) * x_t)

    # ----------------------------------------------------------- p_mean_var

    def p_mean_variance(self, model_fn, x_t, t, **model_kwargs):
        out = model_fn(x_t, self.model_t(t), **model_kwargs)
        if self.cfg.predict == "epsilon":
            x_start = self.predict_xstart_from_eps(x_t, t, out)
        else:
            x_start = out
        if self.cfg.clip_denoised:
            x_start = torch.clamp(x_start, -1.0, 1.0)
        mean = self.q_posterior_mean(x_start, x_t, t)
        table = ("posterior_log_variance_clipped" if self.cfg.var_type == "fixed_small"
                 else "log_betas")
        return mean, self._gather(table, t, x_t.ndim), x_start

    # -------------------------------------------------------------- sampling

    def _draws(self, shape, x_init, step_noise, generator, device):
        """The loop's start and a function of the step giving its noise: the
        injected ones, else draws from ``generator`` (seed 0 when None) on
        ``device`` (the card unless the caller says otherwise), the start
        first, then one a step."""
        dev = x_init.device if x_init is not None and device is None else resolve_device(device)
        if x_init is None or step_noise is None:
            generator = generator or torch.Generator(device=dev).manual_seed(0)
        if x_init is None:
            x_init = torch.randn(shape, generator=generator, device=dev)
        if step_noise is None:
            return x_init, lambda i: torch.randn(shape, generator=generator, device=dev)
        return x_init, lambda i: step_noise[i]

    def p_sample_loop(self, model_fn, shape, *, x_init: Optional[torch.Tensor] = None,
                      step_noise: Optional[Sequence[torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None, device=None,
                      **model_kwargs) -> torch.Tensor:
        """Ancestral DDPM sampling (p_sample_loop's), one model call a step.
        ``step_noise[i]`` is step i's noise (the last step's is drawn and
        multiplied by 0, as in JAX)."""
        x, noise = self._draws(shape, x_init, step_noise, generator, device)
        for i in range(self.num_timesteps):
            ti = self.num_timesteps - 1 - i
            t = torch.full((shape[0],), ti, dtype=torch.long, device=x.device)
            mean, log_var, _ = self.p_mean_variance(model_fn, x, t, **model_kwargs)
            x = mean + (1.0 if ti > 0 else 0.0) * torch.exp(0.5 * log_var) * noise(i)
        return x

    def ddim_sample_loop(self, model_fn, shape, *, eta: float = 0.0,
                         x_init: Optional[torch.Tensor] = None,
                         step_noise: Optional[Sequence[torch.Tensor]] = None,
                         generator: Optional[torch.Generator] = None, device=None,
                         **model_kwargs) -> torch.Tensor:
        """Deterministic (eta=0) or stochastic DDIM (ddim_sample_loop's)."""
        x, noise = self._draws(shape, x_init, step_noise, generator, device)
        for i in range(self.num_timesteps):
            ti = self.num_timesteps - 1 - i
            t = torch.full((shape[0],), ti, dtype=torch.long, device=x.device)
            _, _, x_start = self.p_mean_variance(model_fn, x, t, **model_kwargs)
            eps = ((self._gather("sqrt_recip_alphas_cumprod", t, x.ndim) * x - x_start)
                   / self._gather("sqrt_recipm1_alphas_cumprod", t, x.ndim))
            a_t = self._gather("alphas_cumprod", t, x.ndim)
            a_prev = self._gather("alphas_cumprod_prev", t, x.ndim)
            sigma = eta * torch.sqrt((1 - a_prev) / (1 - a_t)) * torch.sqrt(1 - a_t / a_prev)
            mean = (torch.sqrt(a_prev) * x_start
                    + torch.sqrt(torch.clamp(1 - a_prev - sigma**2, min=0.0)) * eps)
            x = mean + (1.0 if ti > 0 else 0.0) * sigma * noise(i)
        return x

    # ---------------------------------------------------------------- losses

    def training_loss(self, model_fn, x_start, t, *, noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      **model_kwargs) -> Dict[str, torch.Tensor]:
        """MSE on eps (the core of gaussian_diffusion's training_losses);
        ``noise`` is drawn from ``generator`` when not given."""
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=x_start.device)
        x_t = self.q_sample(x_start, t, noise)
        out = model_fn(x_t, self.model_t(t), **model_kwargs)
        target = noise if self.cfg.predict == "epsilon" else x_start
        mse = torch.mean(torch.square(out - target), dim=tuple(range(1, x_start.ndim)))
        return {"loss": torch.mean(mse), "per_sample": mse}


# -------------------------------------------------------------------- sampler


class UniformSampler:
    """resample.UniformSampler: timesteps uniform, importance weights 1."""

    def __init__(self, diffusion: GaussianDiffusion):
        self.n = diffusion.num_timesteps

    def sample(self, batch: int, *, generator: Optional[torch.Generator] = None,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        t = torch.randint(0, self.n, (batch,), generator=generator, device=device)
        return t, torch.ones((batch,), device=device)


class LossSecondMomentResampler:
    """resample.LossSecondMomentResampler: timesteps drawn ∝ the RMS of
    recent per-timestep losses, with importance weights."""

    def __init__(self, diffusion: GaussianDiffusion, *, history: int = 10,
                 uniform_prob: float = 0.001):
        self.n = diffusion.num_timesteps
        self.history = history
        self.uniform_prob = uniform_prob
        self._losses = np.zeros((self.n, history), np.float64)
        self._counts = np.zeros(self.n, np.int64)

    def weights(self) -> np.ndarray:
        if not (self._counts == self.history).all():
            return np.ones(self.n)
        w = np.sqrt(np.mean(self._losses**2, axis=-1))
        w = w / w.sum()
        return w * (1 - self.uniform_prob) + self.uniform_prob / self.n

    def sample(self, batch: int, *, generator: Optional[torch.Generator] = None,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        w = self.weights()
        p = w / w.sum()
        t = torch.multinomial(torch.as_tensor(p, device=device), batch, replacement=True,
                              generator=generator)
        weights = 1.0 / (self.n * p[t.cpu().numpy()])
        return t, torch.as_tensor(weights, dtype=torch.float32, device=device)

    def update_with_losses(self, ts, losses) -> None:
        for t, loss in zip(np.asarray(ts), np.asarray(losses)):
            idx = int(self._counts[t]) % self.history
            self._losses[t, idx] = float(loss)
            self._counts[t] = min(self._counts[t] + 1, self.history)


# ------------------------------------------------------------------------ nn


def timestep_embedding(t: torch.Tensor, dim: int, *, max_period: float = 10000.0) -> torch.Tensor:
    """guided_diffusion.nn.timestep_embedding: [B] → [B, dim], cos before
    sin, an odd ``dim`` padded with a zero column (not
    ``models/musetalk.py``'s diffusers embedding)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def ema_update(ema_params, params, rate: float = 0.9999):
    """guided_diffusion.nn.update_ema over nested dicts / lists of tensors:
    a new tree, ``ema · rate + param · (1 − rate)`` in the EMA's dtype."""
    if isinstance(ema_params, dict):
        return {k: ema_update(v, params[k], rate) for k, v in ema_params.items()}
    if isinstance(ema_params, (list, tuple)):
        return [ema_update(e, p, rate) for e, p in zip(ema_params, params)]
    return ema_params * rate + params.to(ema_params.dtype) * (1 - rate)
