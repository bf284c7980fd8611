"""The port's guided-diffusion core against the JAX package's on the CPU.

The schedules, ``space_timesteps`` and every respaced table are held
exactly (both build them in float64 numpy); ``q_sample``, the x_0 / eps
algebra and ``p_mean_variance`` within 1e-5; the DDPM and DDIM loops over a
toy model with JAX's own draws injected (its key schedule rebuilt: ``key,
k0 = split(key)`` for the start, ``key, kn = split(key)`` a step) within
1e-5; ``training_loss`` with JAX's noise injected; the timestep samplers'
weights; ``timestep_embedding`` within 1e-6 beyond t·ulp(freq) (XLA's and
torch's f32 exp differ by an ulp at some frequencies) and ``ema_update``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from expressive_speech_translation_tpu.models import diffusion as jdf
from expressive_speech_translation_tpu_torch.models import diffusion as tdf

CPU = "cpu"
ATOL = 1e-5
SHAPE = (2, 3, 4, 4)

TABLES = ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
          "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
          "sqrt_recipm1_alphas_cumprod", "posterior_variance",
          "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2")


def _pair(steps=64, respacing=None, **cfg):
    use = jdf.space_timesteps(steps, respacing) if respacing else None
    return (jdf.GaussianDiffusion(jdf.DiffusionConfig(steps=steps, **cfg), use_timesteps=use),
            tdf.GaussianDiffusion(tdf.DiffusionConfig(steps=steps, **cfg), use_timesteps=use))


def _toy(x, t, xp):
    """A deterministic eps model both packages can run: elementwise in x,
    linear in the (original) timestep."""
    scale = t.astype(jnp.float32) if xp is jnp else t.float()
    return 0.6 * x - 0.2 + 1e-3 * scale.reshape((-1,) + (1,) * (x.ndim - 1))


def _jax_toy(x, t, **_):
    return _toy(x, t, jnp)


def _torch_toy(x, t, **_):
    return _toy(x, t, torch)


def _close(got, want, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _jax_loop_draws(key, shape, steps):
    """JAX's loops' draws: the start, then one a step."""
    key, k0 = jax.random.split(key)
    x_init = jax.random.normal(k0, shape)
    noise = []
    for _ in range(steps):
        key, kn = jax.random.split(key)
        noise.append(torch.from_numpy(np.array(jax.random.normal(kn, shape))))
    return torch.from_numpy(np.array(x_init)), noise


# ------------------------------------------------------------------ schedules


@pytest.mark.parametrize("name, steps", [("linear", 1000), ("linear", 7), ("cosine", 100),
                                         ("cosine", 1000)])
def test_beta_schedules_are_equal(name, steps):
    want = jdf.named_beta_schedule(name, steps)
    got = tdf.named_beta_schedule(name, steps)
    assert got.dtype == want.dtype == np.float64 and np.array_equal(got, want)
    with pytest.raises(ValueError, match="unknown beta schedule"):
        tdf.named_beta_schedule("quadratic", steps)


@pytest.mark.parametrize("steps, counts", [(1000, "ddim25"), (100, "ddim10"), (64, "ddim4"),
                                           (100, "10,10"), (1000, "250"), (100, [5, 3, 2]),
                                           (10, "1,1,1")])
def test_space_timesteps_are_equal(steps, counts):
    assert tdf.space_timesteps(steps, counts) == jdf.space_timesteps(steps, counts)


@pytest.mark.parametrize("steps, counts", [(100, "200"), (10, "ddim7")])
def test_space_timesteps_refuses_what_jax_refuses(steps, counts):
    with pytest.raises(ValueError):
        jdf.space_timesteps(steps, counts)
    with pytest.raises(ValueError):
        tdf.space_timesteps(steps, counts)


@pytest.mark.parametrize("steps, respacing, schedule", [(1000, None, "linear"),
                                                        (1000, "ddim25", "linear"),
                                                        (100, "10,5", "cosine")])
def test_the_respaced_tables_are_equal(steps, respacing, schedule):
    jd, td = _pair(steps, respacing, schedule=schedule)
    assert td.num_timesteps == jd.num_timesteps
    if respacing is None:
        assert td.timestep_map is None and jd.timestep_map is None
    else:
        assert td.timestep_map.dtype == np.int32
        assert np.array_equal(td.timestep_map, jd.timestep_map)
    for name in TABLES:
        got, want = getattr(td, name), getattr(jd, name)
        assert got.dtype == np.float64 and np.array_equal(got, want), name


# ------------------------------------------------------------- forward math


def test_q_sample_and_the_x0_algebra_match_jax():
    jd, td = _pair(50, "ddim10")
    g = np.random.default_rng(0)
    x0, noise = (g.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    t = np.array([1, 8])
    jt, tt = jnp.asarray(t), torch.from_numpy(t)
    x_t = td.q_sample(torch.from_numpy(x0), tt, torch.from_numpy(noise))
    _close(x_t, jd.q_sample(jnp.asarray(x0), jt, jnp.asarray(noise)))
    _close(td.predict_xstart_from_eps(x_t, tt, torch.from_numpy(noise)),
           jd.predict_xstart_from_eps(jnp.asarray(x_t.numpy()), jt, jnp.asarray(noise)))
    _close(td.q_posterior_mean(torch.from_numpy(x0), x_t, tt),
           jd.q_posterior_mean(jnp.asarray(x0), jnp.asarray(x_t.numpy()), jt))
    assert td.model_t(tt).tolist() == np.asarray(jd.model_t(jt)).tolist()
    assert td.model_t(tt).dtype == torch.long


@pytest.mark.parametrize("predict, var_type, clip", [("epsilon", "fixed_small", True),
                                                     ("epsilon", "fixed_large", False),
                                                     ("x_start", "fixed_small", True)])
def test_p_mean_variance_matches_jax(predict, var_type, clip):
    jd, td = _pair(64, "ddim8", predict=predict, var_type=var_type, clip_denoised=clip)
    x = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32) * 2.0
    t = np.array([0, 6])
    got = td.p_mean_variance(_torch_toy, torch.from_numpy(x), torch.from_numpy(t))
    want = jd.p_mean_variance(_jax_toy, jnp.asarray(x), jnp.asarray(t))
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32
        _close(g_, w_)


# ----------------------------------------------------------------- sampling


@pytest.mark.parametrize("loop, eta, respacing", [("ddim", 0.0, "ddim4"), ("ddim", 0.5, "ddim4"),
                                                  ("ddim", 1.0, None), ("ddpm", None, "3,2"),
                                                  ("ddpm", None, None)])
def test_the_sample_loops_match_jax_with_its_draws_injected(loop, eta, respacing):
    jd, td = _pair(16, respacing)
    key = jax.random.PRNGKey(7)
    x_init, noise = _jax_loop_draws(key, SHAPE, td.num_timesteps)
    if loop == "ddim":
        want = jd.ddim_sample_loop(_jax_toy, SHAPE, key, eta=eta)
        got = td.ddim_sample_loop(_torch_toy, SHAPE, eta=eta, x_init=x_init, step_noise=noise)
    else:
        want = jd.p_sample_loop(_jax_toy, SHAPE, key)
        got = td.p_sample_loop(_torch_toy, SHAPE, x_init=x_init, step_noise=noise)
    assert got.dtype == torch.float32
    _close(got, want)


def test_the_loops_keep_f32_arithmetic_over_a_bf16_model():
    """A bf16 model output meets the f32 tables and sample: the loop's
    arithmetic promotes to f32, as JAX's does."""
    jd, td = _pair(16, "ddim4")
    key = jax.random.PRNGKey(3)
    x_init, noise = _jax_loop_draws(key, SHAPE, td.num_timesteps)

    def jax_bf16(x, t, **_):
        return _toy(x, t, jnp).astype(jnp.bfloat16)

    def torch_bf16(x, t, **_):
        return _toy(x, t, torch).to(torch.bfloat16)

    want = jd.ddim_sample_loop(jax_bf16, SHAPE, key)
    got = td.ddim_sample_loop(torch_bf16, SHAPE, x_init=x_init, step_noise=noise)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want)


def test_the_loops_draw_from_a_generator_when_nothing_is_injected():
    _, td = _pair(16, "ddim4")
    runs = [td.ddim_sample_loop(_torch_toy, SHAPE, eta=0.5,
                                generator=torch.Generator().manual_seed(s), device=CPU)
            for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    # the generator gives the start first, then a draw a step
    g = torch.Generator().manual_seed(5)
    x_init = torch.randn(SHAPE, generator=g)
    steps = [torch.randn(SHAPE, generator=g) for _ in range(td.num_timesteps)]
    assert torch.equal(td.ddim_sample_loop(_torch_toy, SHAPE, eta=0.5, x_init=x_init,
                                           step_noise=steps), runs[0])


def test_the_loops_need_the_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, td = _pair(16, "ddim4")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.ddim_sample_loop(_torch_toy, SHAPE)


@pytest.mark.parametrize("loop, tol", [("ddim", 0.02), ("ddpm", 0.15)])
def test_both_samplers_recover_the_oracle_image(loop, tol):
    """tests/test_diffusion.py's oracle: a model predicting the true eps
    toward a constant image leads both samplers to it."""
    _, td = _pair(64)
    target = 0.5

    def oracle(x_t, t, **_):
        a = td._gather("sqrt_alphas_cumprod", t, x_t.ndim)
        b = td._gather("sqrt_one_minus_alphas_cumprod", t, x_t.ndim)
        return (x_t - a * target) / torch.clamp(b, min=1e-8)

    gen = torch.Generator().manual_seed(0)
    run = td.ddim_sample_loop if loop == "ddim" else td.p_sample_loop
    x = run(oracle, (1, 3, 4, 4), generator=gen, device=CPU)
    assert abs(float(x.mean()) - target) < tol


# ------------------------------------------------------- losses and samplers


@pytest.mark.parametrize("predict", ["epsilon", "x_start"])
def test_training_loss_matches_jax(predict):
    jd, td = _pair(32, "ddim8", predict=predict)
    x0 = np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    t = np.array([1, 7])
    key = jax.random.PRNGKey(4)
    noise = torch.from_numpy(np.array(jax.random.normal(key, SHAPE)))
    want = jd.training_loss(_jax_toy, jnp.asarray(x0), jnp.asarray(t), key)
    got = td.training_loss(_torch_toy, torch.from_numpy(x0), torch.from_numpy(t), noise=noise)
    _close(got["per_sample"], want["per_sample"])
    _close(got["loss"], want["loss"])
    drawn = td.training_loss(_torch_toy, torch.from_numpy(x0), torch.from_numpy(t),
                             generator=torch.Generator().manual_seed(0))
    assert drawn["per_sample"].shape == (2,)


def test_the_timestep_samplers_match_jax():
    jd, td = _pair(10)
    u = tdf.UniformSampler(td)
    t, w = u.sample(64, generator=torch.Generator().manual_seed(0))
    assert t.shape == (64,) and int(t.min()) >= 0 and int(t.max()) < 10 and torch.all(w == 1)

    jr = jdf.LossSecondMomentResampler(jd, history=2)
    tr = tdf.LossSecondMomentResampler(td, history=2)
    assert np.array_equal(tr.weights(), jr.weights())        # uniform before the warm-up
    for k in range(3):
        ts, losses = np.arange(10), np.linspace(0.1, 2.0, 10) * (k + 1)
        jr.update_with_losses(ts, losses)
        tr.update_with_losses(ts, losses)
    assert np.array_equal(tr.weights(), jr.weights())
    assert tr.weights()[9] > tr.weights()[0]
    t, imp = tr.sample(256, generator=torch.Generator().manual_seed(1))
    p = jr.weights() / jr.weights().sum()
    assert t.shape == imp.shape == (256,) and imp.dtype == torch.float32
    np.testing.assert_allclose(imp.numpy(), (1.0 / (10 * p[t.numpy()])).astype(np.float32))
    assert len(set(t.tolist())) > 1


@pytest.mark.parametrize("dim", [32, 33, 8])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([0, 5, 100, 999])
    got = tdf.timestep_embedding(torch.from_numpy(t), dim)
    want = jdf.timestep_embedding(jnp.asarray(t), dim)
    assert got.shape == (4, dim) and got.dtype == torch.float32
    # XLA's f32 exp and torch's differ by an ulp at some frequencies, which
    # moves cos / sin of t·freq by up to t·ulp(freq): 1e-6 beyond that
    half = dim // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / half).astype(np.float32)
    slack = t[:, None] * np.spacing(freqs)[None, :]
    err = np.abs(got.numpy()[:, :2 * half] - np.asarray(want)[:, :2 * half])
    assert np.all(err <= 1e-6 + np.concatenate([slack, slack], axis=1)), err.max()
    if dim % 2:
        assert torch.all(got[:, -1] == 0)


def test_ema_update_matches_jax():
    g = np.random.default_rng(3)
    ema = {"w": g.standard_normal(4).astype(np.float32), "blocks": [g.standard_normal((2, 3))
                                                                    .astype(np.float32)]}
    params = {"w": g.standard_normal(4).astype(np.float32), "blocks": [g.standard_normal((2, 3))
                                                                       .astype(np.float32)]}
    want = jdf.ema_update(jax.tree.map(jnp.asarray, ema), jax.tree.map(jnp.asarray, params), 0.9)
    got = tdf.ema_update(jax.tree.map(torch.from_numpy, ema),
                         {"w": torch.from_numpy(params["w"]).to(torch.float64),
                          "blocks": [torch.from_numpy(params["blocks"][0])]}, rate=0.9)
    assert got["w"].dtype == torch.float32 and isinstance(got["blocks"], list)
    _close(got["w"], want["w"], atol=1e-6)
    _close(got["blocks"][0], want["blocks"][0], atol=1e-6)
