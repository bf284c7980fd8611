"""OpenVoice v2 (the tone-colour converter, its converters, loader, emitter
and bake) against the JAX package on the CPU.

The model runs at ``tests/test_openvoice_convert.py``'s toy ``CFG`` (n_spec 65,
so F' = 2 after the six stride-2 convs and the GRU's channel-major input order
shows) on JAX's init with every bias and the flow's zero-initialised post
convs moved off 0, carried across by ``from_jax_params``: ``extract_se``,
``posterior_encode`` (the mean, and with JAX's draw injected), the flow both
ways and its round trip, ``generator_decode``, ``spectrogram_22k`` and
``convert_tone`` each within F32_RTOL of the output's peak. The converter of
that file's torch mirror (weight-normed, SynthesizerTrn naming) is bit-equal
to JAX's, and so are ``load_openvoice`` and the ``openvoice/`` bake; the
port's emitter writes the mirror's keys and reads back within the
weight-norm fold's rounding.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from expressive_speech_translation_tpu.models import loaders as jld
from expressive_speech_translation_tpu.models import openvoice as jov
from expressive_speech_translation_tpu_torch.models import loaders as tld
from expressive_speech_translation_tpu_torch.models import openvoice as tov
from expressive_speech_translation_tpu_torch.obs import checkpoint_emitters as em

from test_openvoice_convert import CFG, Coupling, TorchConverter

CPU = "cpu"
# f32, port against JAX: max |diff| over the output's peak. The deepest
# conversion (spectrogram → posterior → flows → generator) measures 3.3e-7
# here, the published-width spectrogram 6.2e-7.
F32_RTOL = 1e-4
# the port's forward against the torch mirror (same weights, torch both
# sides), as tests/test_openvoice_convert.py holds JAX to it
MIRROR_ATOL = 2e-4
# the emitter's weight norm read back: g·v/‖v‖ rounds twice (a product and a
# quotient), so a weight comes back within one f32 ulp of its magnitude
FOLD_RTOL = 2.0 ** -23
T_FRAMES = 17
# spectrogram_22k needs n_spec = n_fft/2 + 1; CFG keeps the default n_fft
SPEC_CFG = dataclasses.replace(CFG, n_fft=128, hop=32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=F32_RTOL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    peak = np.abs(want).max()
    assert peak > 0 and np.abs(got - want).max() <= rtol * peak, (np.abs(got - want).max(), peak)


def assert_trees_equal(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path


@pytest.fixture(scope="module")
def trees():
    """(JAX tree as numpy, the port's tree from it). Every bias and the
    flow's post kernels drawn, so the bias paths and the SE-conditioned
    coupling are exercised (VITS zero-initialises the posts)."""
    tree = _np(jov.init_openvoice(jax.random.PRNGKey(3), CFG))
    g = np.random.default_rng(4)

    def perturb(node, key=""):
        if isinstance(node, dict):
            return {k: perturb(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [perturb(v, key) for v in node]
        if key == "bias":
            return g.normal(0, 0.1, node.shape).astype(np.float32)
        return np.array(node)

    tree = perturb(tree)
    for layer in tree["flow"]:
        layer["post"]["kernel"] = g.normal(0, 0.3, layer["post"]["kernel"].shape).astype(np.float32)
    return tree, tov.from_jax_params(tree, CPU)


def _inputs(seed=9):
    g = np.random.default_rng(seed)
    spec = g.uniform(0.0, 1.0, (2, T_FRAMES, CFG.n_spec)).astype(np.float32)
    se_src = g.standard_normal((2, CFG.se_dim)).astype(np.float32)
    se_tgt = g.standard_normal((2, CFG.se_dim)).astype(np.float32)
    return spec, se_src, se_tgt


def _jit(fn, cfg=CFG):
    return jax.jit(functools.partial(fn, cfg=cfg))


def test_extract_se_matches_jax(trees):
    jtree, params = trees
    spec, _, _ = _inputs()
    want = _jit(lambda p, s, cfg: jov.extract_se(p, cfg, s))(jtree, spec)
    _close(tov.extract_se(params, CFG, torch.from_numpy(spec)), want)


@pytest.mark.parametrize("tau", [0.0, 0.3])
def test_posterior_encode_matches_jax(trees, tau):
    """τ = 0 gives the mean; at τ = 0.3 JAX's draw at its key is injected."""
    jtree, params = trees
    spec, se_src, _ = _inputs()
    key = jax.random.PRNGKey(11)
    want = _jit(lambda p, s, g, k, cfg: jov.posterior_encode(p, cfg, s, g, tau=tau, key=k))(
        jtree["enc_q"], spec, se_src, key)
    eps = np.array(jax.random.normal(key, (2, T_FRAMES, CFG.inter_channels), jnp.float32))
    got = tov.posterior_encode(params["enc_q"], CFG, torch.from_numpy(spec),
                               torch.from_numpy(se_src), tau=tau, eps=torch.from_numpy(eps))
    _close(got, want)
    if tau:
        mean = tov.posterior_encode(params["enc_q"], CFG, torch.from_numpy(spec),
                                    torch.from_numpy(se_src), tau=tau)
        assert not torch.allclose(mean, got)


def test_flow_both_ways_and_its_round_trip_match_jax(trees):
    jtree, params = trees
    g = np.random.default_rng(5)
    z = g.standard_normal((2, T_FRAMES, CFG.inter_channels)).astype(np.float32)
    _, se_src, se_tgt = _inputs()
    fwd = _jit(lambda p, z, s, cfg: jov.flow_forward(p, cfg, z, s))(jtree, z, se_src)
    inv = _jit(lambda p, z, s, cfg: jov.flow_inverse(p, cfg, z, s))(jtree, z, se_tgt)
    z_t = torch.from_numpy(z)
    got_fwd = tov.flow_forward(params, CFG, z_t, torch.from_numpy(se_src))
    _close(got_fwd, fwd)
    _close(tov.flow_inverse(params, CFG, z_t, torch.from_numpy(se_tgt)), inv)
    back = tov.flow_inverse(params, CFG, got_fwd, torch.from_numpy(se_src))
    _close(back, z)
    assert not torch.allclose(got_fwd, z_t, atol=1e-3)      # the flow is not the identity


def test_generator_decode_matches_jax(trees):
    jtree, params = trees
    g = np.random.default_rng(6)
    z = g.standard_normal((2, T_FRAMES, CFG.inter_channels)).astype(np.float32)
    _, se_src, _ = _inputs()
    want = _jit(lambda p, z, s, cfg: jov.generator_decode(p, cfg, z, s))(jtree["dec"], z, se_src)
    got = tov.generator_decode(params["dec"], CFG, torch.from_numpy(z), torch.from_numpy(se_src))
    assert got.shape == (2, T_FRAMES * int(np.prod(CFG.upsample_rates)))
    _close(got, want)


@pytest.mark.parametrize("cfg", [SPEC_CFG, jov.OpenVoiceConfig()], ids=["toy", "published"])
def test_spectrogram_22k_matches_jax(cfg):
    x = np.random.default_rng(7).uniform(-0.5, 0.5, (2, 5_000)).astype(np.float32)
    want = jov.spectrogram_22k(jnp.asarray(x), cfg)
    tcfg = tov.OpenVoiceConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    got = tov.spectrogram_22k(torch.from_numpy(x), tcfg)
    assert got.shape == (2, (5_000 - cfg.hop) // cfg.hop + 1, cfg.n_fft // 2 + 1)
    _close(got, want)


@pytest.mark.parametrize("with_draw", [False, True])
def test_convert_tone_matches_jax(trees, with_draw):
    """The whole conversion (spectrogram → posterior → flow → inverse flow →
    generator) at τ = 0.3: the posterior's mean, or JAX's draw injected."""
    jtree, params = trees
    x = np.random.default_rng(8).uniform(-0.5, 0.5, (2, 4_000)).astype(np.float32)
    _, se_src, se_tgt = _inputs()
    key = jax.random.PRNGKey(13) if with_draw else None
    want = _jit(lambda p, a, s, t, k, cfg: jov.convert_tone(p, cfg, a, s, t, key=k),
                SPEC_CFG)(jtree, x, se_src, se_tgt, key)
    frames = (4_000 - SPEC_CFG.hop) // SPEC_CFG.hop + 1
    eps = (torch.from_numpy(np.array(jax.random.normal(
        key, (2, frames, CFG.inter_channels), jnp.float32))) if with_draw else None)
    got = tov.convert_tone(params, SPEC_CFG, torch.from_numpy(x), torch.from_numpy(se_src),
                           torch.from_numpy(se_tgt), eps=eps)
    assert got.shape == (2, frames * int(np.prod(CFG.upsample_rates)))
    _close(got, want)


# ------------------------------------------------------------------ converters


@pytest.fixture(scope="module")
def mirror():
    torch.manual_seed(7)
    tm = TorchConverter(CFG).eval()
    with torch.no_grad():
        for f in tm.flow.flows:
            if isinstance(f, Coupling):
                f.post.weight.normal_(0, 0.3)
                f.post.bias.normal_(0, 0.1)
    return tm


@pytest.mark.parametrize("wrapped", [False, True])
def test_state_dict_converter_is_bit_equal_to_jax(mirror, wrapped):
    """The mirror's weight-normed state dict (and the ``{"model": ...}``
    wrapper OpenVoice saves): the port's tree equals ``from_jax_params`` of
    JAX's converter's, bit for bit."""
    sd = mirror.state_dict()
    assert any(k.endswith("weight_g") for k in sd)
    sd = {"model": sd} if wrapped else sd
    assert_trees_equal(tov.from_openvoice_state_dict(sd, CFG, CPU),
                       tov.from_jax_params(_np(jov.from_openvoice_state_dict(sd, CFG)), CPU))


def test_the_port_matches_the_torch_mirror(mirror):
    params = tov.from_openvoice_state_dict(mirror.state_dict(), CFG, CPU)
    spec, se_src, se_tgt = _inputs()
    with torch.no_grad():
        _close(tov.extract_se(params, CFG, torch.from_numpy(spec)),
               mirror.ref_enc(torch.from_numpy(spec)).numpy(), MIRROR_ATOL)
        want = mirror.voice_conversion(torch.from_numpy(spec).transpose(1, 2),
                                       torch.from_numpy(se_src), torch.from_numpy(se_tgt))
        zeros = torch.zeros(2, CFG.se_dim)
        z = tov.posterior_encode(params["enc_q"], CFG, torch.from_numpy(spec), zeros)
        z = tov.flow_inverse(params, CFG, tov.flow_forward(params, CFG, z,
                                                           torch.from_numpy(se_src)),
                             torch.from_numpy(se_tgt))
        got = tov.generator_decode(params["dec"], CFG, z, zeros)
    assert np.abs(got.numpy() - want.numpy()).max() <= MIRROR_ATOL


def test_load_openvoice_is_bit_equal_to_jax(mirror, tmp_path):
    torch.save({"model": mirror.state_dict()}, tmp_path / "checkpoint.pth")
    got, got_cfg = tld.load_openvoice(tmp_path, CFG, device=CPU)
    want, want_cfg = jld.load_openvoice(tmp_path, CFG)
    assert got_cfg == CFG and want_cfg == CFG
    assert_trees_equal(got, tov.from_jax_params(_np(want), CPU))
    with pytest.raises(tld.WeightsNotFoundError, match="checkpoint.pth"):
        tld.load_openvoice(tmp_path / "missing", device=CPU)


# a configuration config.json can state whole: OpenVoice's config carries no
# flow count, WN depths or reference filters, so those keep their defaults
JSON_CFG = tov.OpenVoiceConfig(n_fft=128, hop=32, n_spec=65, inter_channels=8, hidden=16,
                               se_dim=16, upsample_initial=32,
                               resblock_kernels=(3, 7), resblock_dilations=((1, 3), (1, 3)))


def test_emitter_config_bake_and_loaders_round_trip(tmp_path):
    """The port's emitter writes the mirror's keys; JAX's and the port's
    ``load_openvoice`` read its directory (config from ``config.json``) to
    equal configs and bit-equal trees, within the fold's rounding of the
    emitted tree; the bake reads back by ``load_converted`` unchanged."""
    params = tov.init_openvoice(2, JSON_CFG, CPU)
    src = em.write_openvoice(tmp_path / "converter", params, JSON_CFG)
    sd = torch.load(src / "checkpoint.pth", weights_only=True)["model"]
    assert set(sd) == set(TorchConverter(JSON_CFG).state_dict())
    assert json.loads((src / "config.json").read_text())["model"]["gin_channels"] == 16

    got, cfg = tld.load_openvoice(src, device=CPU)
    want, jcfg = jld.load_openvoice(src)
    assert cfg == JSON_CFG
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert_trees_equal(got, tov.from_jax_params(_np(want), CPU))

    def within_fold(a, b):
        if isinstance(b, dict):
            for k in b:
                within_fold(a[k], b[k])
        elif isinstance(b, list):
            for x, y in zip(a, b):
                within_fold(x, y)
        else:
            assert a.shape == b.shape and (a - b).abs().max() <= FOLD_RTOL * b.abs().max()

    within_fold(got, params)

    tld.bake_models(tmp_path / "bake", openvoice=str(src), device=CPU)
    baked, baked_cfg = tld.load_converted(tmp_path / "bake" / "openvoice", tov.OpenVoiceConfig,
                                          CPU)
    assert baked_cfg == JSON_CFG
    assert_trees_equal(baked, got)
    assert tld.main(["--openvoice", str(src), "--out", str(tmp_path / "cli"),
                     "--device", CPU]) == 0
    assert (tmp_path / "cli" / "openvoice" / "params.safetensors").exists()
    from expressive_speech_translation_tpu_torch.models import seamless as tsm   # ported: bakes
    scfg = tsm.SeamlessConfig.toy()
    seamless_src = em.write_seamless(tmp_path / "seamless-src", tsm.init_seamless(0, scfg, CPU),
                                     scfg, text_lang_ids={"fra": 300},
                                     vocoder_lang_ids={"fra": 1})
    tld.bake_models(tmp_path / "x", seamless=str(seamless_src), device=CPU)
    assert (tmp_path / "x" / "seamless" / "params.safetensors").exists()


def test_init_openvoice_follows_the_jax_tree():
    """The port's seeded init has JAX's structure at the published width,
    every leaf at the port's layout of JAX's shape."""
    cfg = jov.OpenVoiceConfig()
    shapes = jax.eval_shape(lambda: jov.init_openvoice(jax.random.PRNGKey(0), cfg))
    jtree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = tov.from_jax_params(jtree, CPU)
    got = tov.init_openvoice(0, tov.OpenVoiceConfig(), CPU)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, want))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == torch.float32


def test_entry_points_need_the_card(mirror, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tov.init_openvoice(0, CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tov.from_openvoice_state_dict(mirror.state_dict(), CFG)
    torch.save({"model": mirror.state_dict()}, tmp_path / "checkpoint.pth")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tld.load_openvoice(tmp_path, CFG)
