"""The port's checkpoint path against the JAX package's on the CPU.

- ``models/safetensors_io.py`` reads and writes what the ``safetensors``
  library writes and reads, for every dtype it takes, and sharded index
  directories load through ``load_state_dict``.
- The converters and loaders (``load_whisper`` from ``model.safetensors``,
  ``load_nllb`` from ``pytorch_model.bin``, ``load_ecapa``,
  ``load_qwen2_backbone``) give, from toy HF / speechbrain checkpoints with
  random weights, exactly the tree that the JAX loaders followed by
  ``from_jax_params`` give (f32, bit for bit); a bf16 checkpoint loads in
  the port and raises in JAX (``t2j`` calls ``.numpy()`` on it).
- The bake (``bake_models`` → stage directories of ``config.json`` +
  ``params.safetensors``) reloads equal trees, and its ``config.json`` is the
  JAX package's text. ``torch_engines`` serves it under ``EST_MODELS_DIR`` as
  ``jax_engines`` serves its orbax bake: explicit keys win, directories
  without ``config.json`` are skipped, an orbax stage directory is refused,
  and a toy ``translate_speech`` from the port's bake is token-exact with
  JAX's from its bake of the same checkpoints.
- ``obs/checkpoint_emitters.py`` (``chip_smoke.py``'s writers) gives the key
  sets and shapes of the transformers models' ``state_dict()``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from expressive_speech_translation_tpu.models import ecapa as jec
from expressive_speech_translation_tpu.models import loaders as jld
from expressive_speech_translation_tpu.models import nllb as jnl
from expressive_speech_translation_tpu.models import qwen2 as jq2
from expressive_speech_translation_tpu.models import speech_tokenizer as jst
from expressive_speech_translation_tpu.models import whisper as jwh
from expressive_speech_translation_tpu.models.common import host_init
from expressive_speech_translation_tpu.pipeline.cascaded import CascadedBackend as JaxBackend
from expressive_speech_translation_tpu.pipeline.jax_engines import jax_engines
from expressive_speech_translation_tpu_torch.models import cosyvoice as tcv
from expressive_speech_translation_tpu_torch.models import cosyvoice_official as tco
from expressive_speech_translation_tpu_torch.models import ecapa as tec
from expressive_speech_translation_tpu_torch.models import flow_matcha as tfm
from expressive_speech_translation_tpu_torch.models import hift as thm
from expressive_speech_translation_tpu_torch.models import loaders as tld
from expressive_speech_translation_tpu_torch.models import nllb as tnl
from expressive_speech_translation_tpu_torch.models import qwen2 as tq2
from expressive_speech_translation_tpu_torch.models import speech_tokenizer as tst
from expressive_speech_translation_tpu_torch.models import whisper as twh
from expressive_speech_translation_tpu_torch.models.safetensors_io import (DTYPES,
                                                                          read_safetensors,
                                                                          write_safetensors)
from expressive_speech_translation_tpu_torch.obs import checkpoint_emitters as em
from expressive_speech_translation_tpu_torch.pipeline.cascaded import CascadedBackend
from expressive_speech_translation_tpu_torch.pipeline.languages import nllb_placeholder_lang_ids
from expressive_speech_translation_tpu_torch.pipeline.torch_engines import torch_engines

from test_ecapa_convert import TorchEcapa
from test_torch_engine_wiring import TINY as ETINY
from test_torch_convert import _llm_state, assert_trees_equal
from test_torch_official import TINY as OTINY
from test_torch_pipeline import CCFG, TCCFG, JaxCallNoise, _speechlike

CPU = "cpu"
# ECAPA at toy width, 80 mels and 192-wide x-vectors (what the TTS engines take)
ECFG = jec.EcapaConfig(n_mels=80, channels=16, mfa_out=48, bottleneck=8, scale=4,
                       embed_dim=192, attn_channels=8)
STCFG = jst.SpeechTokenizerConfig(dim=32, layers=1, heads=2)
NMT_VOCAB = 260   # every id past the four specials decodes to a byte


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _fields(cfg):
    return dataclasses.asdict(cfg)


# ---------------------------------------------------------------- checkpoints


def _hf_whisper(**overrides):
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    # the multilingual vocabulary, so the prompt's special ids exist; toy widths
    hf = dict(vocab_size=51_865, num_mel_bins=80, encoder_layers=1, decoder_layers=1,
              encoder_attention_heads=2, decoder_attention_heads=2, d_model=32,
              encoder_ffn_dim=64, decoder_ffn_dim=64, max_source_positions=1500,
              max_target_positions=448, eos_token_id=50_257, bos_token_id=50_257,
              pad_token_id=50_257, decoder_start_token_id=50_258)
    hf.update(overrides)
    torch.manual_seed(1)
    return WhisperForConditionalGeneration(WhisperConfig(**hf)).eval()


def _hf_nllb():
    from transformers import M2M100Config, M2M100ForConditionalGeneration

    torch.manual_seed(2)
    return M2M100ForConditionalGeneration(M2M100Config(
        vocab_size=NMT_VOCAB, d_model=32, encoder_layers=1, decoder_layers=1,
        encoder_attention_heads=2, decoder_attention_heads=2, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_position_embeddings=64, pad_token_id=1, bos_token_id=0,
        eos_token_id=2, decoder_start_token_id=2, scale_embedding=True)).eval()


def _speechbrain_ecapa():
    """speechbrain's ECAPA_TDNN naming (the JAX package's test mirror), its
    BatchNorm statistics randomised so the converter's mapping is seen."""
    torch.manual_seed(3)
    model = TorchEcapa(ECFG).eval()
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm1d):
                mod.running_mean.normal_(0, 0.2)
                mod.running_var.uniform_(0.5, 1.5)
    return model


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Toy checkpoints in their published formats: HF Whisper as
    ``model.safetensors``, HF M2M100 as ``pytorch_model.bin``, speechbrain's
    ``embedding_model.ckpt``, and the official CosyVoice2 triple written by
    the port's emitters (``llm.pt``, ``flow.pt``, ``hift.pt``)."""
    root = tmp_path_factory.mktemp("ckpts")
    _hf_whisper().save_pretrained(root / "whisper", safe_serialization=True)
    _hf_nllb().save_pretrained(root / "nllb", safe_serialization=False)
    (root / "ecapa").mkdir()
    torch.save(_speechbrain_ecapa().state_dict(), root / "ecapa" / "embedding_model.ckpt")
    (root / "tts").mkdir()
    official = tco.init_official_tts(5, OTINY, CPU)
    torch.save(em.cosyvoice_llm_state_dict(official["lm"], OTINY.lm), root / "tts" / "llm.pt")
    torch.save(tfm.to_flow_state_dict(official["flow"]), root / "tts" / "flow.pt")
    torch.save(thm.to_hift_state_dict(official["hift"], OTINY.hift), root / "tts" / "hift.pt")
    return root, official


# ---------------------------------------------------------------- safetensors


def _sample(name, dtype):
    g = torch.Generator().manual_seed(7)
    if dtype == torch.bool:
        return torch.rand((3, 5), generator=g) > 0.5
    if dtype.is_floating_point:
        return (torch.randn((3, 5), generator=g) * 100).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, (3, 5), generator=g, dtype=dtype)


@pytest.mark.parametrize("code", sorted(DTYPES))
def test_safetensors_round_trip_with_the_library(tmp_path, code):
    """The port's writer → the library's reader, and the library's writer →
    the port's reader: equal tensors of each dtype, a scalar and an empty
    tensor among them, and the metadata kept."""
    from safetensors import safe_open
    from safetensors.torch import load_file, save_file

    dtype = DTYPES[code]
    tensors = {"w": _sample("w", dtype), "scalar": _sample("s", dtype)[0, 0],
               "empty": torch.zeros((0, 4), dtype=dtype),
               "f32": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    write_safetensors(tensors, tmp_path / "port.safetensors", metadata={"format": "pt"})
    got = load_file(str(tmp_path / "port.safetensors"))
    with safe_open(str(tmp_path / "port.safetensors"), "pt") as f:
        assert f.metadata() == {"format": "pt"}
    save_file(tensors, str(tmp_path / "lib.safetensors"))
    mine = read_safetensors(tmp_path / "lib.safetensors")
    for out in (got, mine):
        assert set(out) == set(tensors)
        for k, t in tensors.items():
            assert out[k].dtype == t.dtype and out[k].shape == t.shape and torch.equal(out[k], t)


def test_safetensors_reader_refuses_other_dtypes_and_broken_files(tmp_path):
    from safetensors.torch import save_file

    save_file({"x": torch.zeros(3, dtype=torch.float64)}, str(tmp_path / "f64.safetensors"))
    with pytest.raises(ValueError, match="dtype F64"):
        read_safetensors(tmp_path / "f64.safetensors")
    with pytest.raises(ValueError, match="float64"):
        write_safetensors({"x": torch.zeros(3, dtype=torch.float64)}, tmp_path / "x.safetensors")
    write_safetensors({"x": torch.ones(64)}, tmp_path / "ok.safetensors")
    data = (tmp_path / "ok.safetensors").read_bytes()
    (tmp_path / "cut.safetensors").write_bytes(data[:-4])
    with pytest.raises(ValueError, match="offsets"):
        read_safetensors(tmp_path / "cut.safetensors")


def test_a_sharded_index_directory_loads_with_torch_alone(tmp_path):
    """``model.safetensors.index.json`` and its shards, written by the
    library, load through ``load_state_dict`` into the union of the shards."""
    from safetensors.torch import save_file

    a = {"model.a": torch.randn(4, 3), "model.b": torch.arange(5)}
    b = {"model.c": torch.randn(2).to(torch.bfloat16)}
    save_file(a, str(tmp_path / "model-00001-of-00002.safetensors"))
    save_file(b, str(tmp_path / "model-00002-of-00002.safetensors"))
    weight_map = {**{k: "model-00001-of-00002.safetensors" for k in a},
                  **{k: "model-00002-of-00002.safetensors" for k in b}}
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    got = tld.load_state_dict(tmp_path)
    assert set(got) == set(weight_map)
    for k, v in {**a, **b}.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v)


# ----------------------------------------------------------------- converters


def test_load_whisper_matches_the_jax_loader(ckpts):
    """``model.safetensors`` + ``config.json`` → the JAX loader's tree
    through ``from_jax_params``, bit for bit, and the same config."""
    root, _ = ckpts
    jparams, jcfg = jld.load_whisper(root / "whisper")
    params, cfg = tld.load_whisper(root / "whisper", device=CPU)
    assert _fields(cfg) == _fields(jcfg)
    assert_trees_equal(params, twh.from_jax_params(_np(jparams), CPU))
    assert params["encoder"]["conv1"]["kernel"].shape == (32, 80, 3)   # [out, in, width]


@pytest.mark.parametrize("model_cls", ["WhisperForConditionalGeneration", "WhisperModel"])
def test_the_whisper_converter_takes_both_roots(model_cls):
    """``model.``-rooted (the conditional-generation model) and bare
    (``WhisperModel``) state dicts, as the JAX converter takes them."""
    import transformers

    hf = _hf_whisper()
    model = hf if model_cls == "WhisperForConditionalGeneration" else hf.model
    assert isinstance(model, getattr(transformers, model_cls))
    state = model.state_dict()
    cfg = twh.WhisperConfig(d_model=32, encoder_layers=1, decoder_layers=1, heads=2, ffn_dim=64)
    jcfg = jwh.WhisperConfig(**_fields(cfg))
    assert_trees_equal(twh.from_hf_state_dict(state, cfg, CPU),
                       twh.from_jax_params(_np(jwh.from_hf_state_dict(state, jcfg)), CPU))


def test_load_nllb_matches_the_jax_loader(ckpts):
    """``pytorch_model.bin`` + ``config.json`` → the JAX loader's tree (the
    sinusoidal table included) through ``from_jax_params``, bit for bit."""
    root, _ = ckpts
    jparams, jcfg = jld.load_nllb(root / "nllb")
    params, cfg = tld.load_nllb(root / "nllb", device=CPU)
    assert _fields(cfg) == _fields(jcfg)
    assert_trees_equal(params, tnl.from_jax_params(_np(jparams), CPU))


@pytest.mark.parametrize("prefix", ["", "embedding_model."])
def test_the_ecapa_converter_matches_the_jax_converter(prefix):
    """speechbrain's naming, bare or under a full-model save's prefix."""
    state = {prefix + k: v for k, v in _speechbrain_ecapa().state_dict().items()}
    cfg = tec.EcapaConfig(**_fields(ECFG))
    want = tec.from_jax_params(_np(jec.from_speechbrain_state_dict(state, ECFG)), CPU)
    assert_trees_equal(tec.from_speechbrain_state_dict(state, cfg, CPU), want)


def test_load_ecapa_reads_the_widths_from_the_tensors(ckpts):
    """A directory holding ``embedding_model.ckpt`` loads as the JAX loader
    loads it given the config; the port reads the config from the shapes."""
    root, _ = ckpts
    jparams, _ = jld.load_ecapa(root / "ecapa", cfg=ECFG)
    params, cfg = tld.load_ecapa(root / "ecapa", device=CPU)
    assert _fields(cfg) == _fields(ECFG)
    assert_trees_equal(params, tec.from_jax_params(_np(jparams), CPU))


def test_load_qwen2_backbone_matches_the_jax_loader(tmp_path):
    from transformers import Qwen2Config, Qwen2Model

    torch.manual_seed(4)
    Qwen2Model(Qwen2Config(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2, intermediate_size=64, vocab_size=100,
                           max_position_embeddings=128)).save_pretrained(
        tmp_path, safe_serialization=True)
    jparams, jcfg = jld.load_qwen2_backbone(tmp_path)
    params, cfg = tld.load_qwen2_backbone(tmp_path, device=CPU)
    assert _fields(cfg) == _fields(jcfg)
    assert_trees_equal(params, tq2.from_jax_params(_np(jparams), CPU))


@pytest.mark.parametrize("size", ["tiny", "base", "small", "medium"])
def test_whisper_sizes_are_the_jax_sizes(size):
    assert _fields(getattr(twh.WhisperConfig, size)()) == _fields(
        getattr(jwh.WhisperConfig, size)())


def test_load_whisper_shifts_large_v3_ids_as_jax_does(tmp_path):
    """large-v3 (vocab 51,866) adds a language token: every special id after
    the language block moves up one, and 128 mels come from config.json."""
    model = _hf_whisper(vocab_size=51_866, num_mel_bins=128, max_source_positions=50,
                        max_target_positions=48)
    torch.save(model.model.state_dict(), tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(model.config.to_json_string())
    params, cfg = tld.load_whisper(tmp_path, device=CPU)
    jparams, jcfg = jld.load_whisper(tmp_path)
    assert _fields(cfg) == _fields(jcfg)
    assert (cfg.n_mels, cfg.n_langs, cfg.task_translate, cfg.task_transcribe, cfg.sop_token,
            cfg.no_speech_token, cfg.no_timestamps) == (128, 100, 50_359, 50_360, 50_362,
                                                        50_363, 50_364)
    assert_trees_equal(params, twh.from_jax_params(_np(jparams), CPU))


def test_load_whisper_refuses_the_english_only_layout(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({
        "num_mel_bins": 80, "d_model": 64, "encoder_layers": 1, "decoder_layers": 1,
        "encoder_attention_heads": 4, "encoder_ffn_dim": 128, "vocab_size": 51_864}))
    with pytest.raises(tld.WeightsNotFoundError, match="English-only"):
        tld.load_whisper(tmp_path, device=CPU)
    with pytest.raises(jld.WeightsNotFoundError, match="English-only"):
        jld.load_whisper(tmp_path)


@pytest.mark.parametrize("family", ["whisper", "nllb"])
def test_a_bf16_checkpoint_loads_in_the_port_and_raises_in_jax(tmp_path, family):
    """JAX's ``t2j`` calls ``.numpy()`` on each tensor, which torch refuses
    for bf16; the port converts the bf16 values to f32 exactly: the tree the
    JAX converter gives from the same values in f32."""
    model = (_hf_whisper() if family == "whisper" else _hf_nllb()).to(torch.bfloat16)
    model.save_pretrained(tmp_path, safe_serialization=family == "whisper")
    jload, load, port = {"whisper": (jld.load_whisper, tld.load_whisper, twh),
                         "nllb": (jld.load_nllb, tld.load_nllb, tnl)}[family]
    with pytest.raises(TypeError, match="BFloat16"):
        jload(tmp_path)
    params, cfg = load(tmp_path, device=CPU)
    jcfg = (jwh.WhisperConfig if family == "whisper" else jnl.NLLBConfig)(**_fields(cfg))
    state = {k: v.float() for k, v in model.state_dict().items()}
    jmod = jwh if family == "whisper" else jnl
    assert_trees_equal(params, port.from_jax_params(_np(jmod.from_hf_state_dict(state, jcfg)),
                                                     CPU))
    assert params["decoder"]["layers"][0]["mlp"]["fc1"]["kernel"].dtype == torch.float32


# ------------------------------------------------------------------- the bake


STAGE_CFGS = {"asr": twh.WhisperConfig, "nmt": tnl.NLLBConfig, "ecapa": tec.EcapaConfig,
              "tts_llm": tcv.SpeechLMConfig, "tts_flow": tfm.OfficialFlowConfig,
              "tts_hift": thm.HiFTConfig}


@pytest.fixture(scope="module")
def baked(ckpts, tmp_path_factory):
    """The port's bake of every toy checkpoint."""
    root, _ = ckpts
    out = tmp_path_factory.mktemp("bake")
    tld.bake_models(out, asr=str(root / "whisper"), nmt=str(root / "nllb"),
                    ecapa=str(root / "ecapa"), tts=str(root / "tts"), device=CPU,
                    tts_llm_cfg=OTINY.lm, tts_flow_cfg=OTINY.flow, tts_hift_cfg=OTINY.hift)
    return out


@pytest.mark.parametrize("stage", ["asr", "nmt", "ecapa", "tts_llm", "tts_flow", "tts_hift"])
def test_the_bake_reloads_the_direct_load_and_writes_the_jax_config(ckpts, baked, stage):
    """``load_converted`` of each stage directory equals the direct load, on
    ``params.safetensors`` alone; ``config.json`` is the JAX package's text
    for the same config."""
    root, _ = ckpts
    direct = {"asr": lambda: tld.load_whisper(root / "whisper", device=CPU),
              "nmt": lambda: tld.load_nllb(root / "nllb", device=CPU),
              "ecapa": lambda: tld.load_ecapa(root / "ecapa", device=CPU),
              "tts_llm": lambda: tld.load_cosyvoice_llm(root / "tts", OTINY.lm, CPU),
              "tts_flow": lambda: tld.load_cosyvoice_flow(root / "tts" / "flow.pt", OTINY.flow,
                                                          CPU),
              "tts_hift": lambda: tld.load_cosyvoice_hift(root / "tts" / "hift.pt",
                                                          OTINY.hift, CPU)}[stage]
    want, want_cfg = direct()
    assert sorted(p.name for p in (baked / stage).iterdir()) == ["config.json",
                                                                  "params.safetensors"]
    params, cfg = tld.load_converted(baked / stage, STAGE_CFGS[stage], device=CPU)
    assert cfg == want_cfg
    assert_trees_equal(params, want)
    if stage in ("asr", "nmt"):
        jcfg = (jld.load_whisper(root / "whisper") if stage == "asr"
                else jld.load_nllb(root / "nllb"))[1]
        assert (baked / stage / "config.json").read_text() == json.dumps(
            dataclasses.asdict(jcfg), indent=2)
    bf16, _ = tld.load_converted(baked / stage, STAGE_CFGS[stage], CPU, torch.bfloat16)
    assert jax.tree.leaves(bf16)[0].dtype == torch.bfloat16


def test_load_official_tts_gives_the_emitted_triple(ckpts, baked):
    _, official = ckpts
    params, cfg = tld.load_official_tts(baked, device=CPU)
    assert cfg == OTINY
    assert_trees_equal(params, official)


def test_the_bake_cli_and_the_families_it_does_not_port(ckpts, tmp_path):
    root, _ = ckpts
    assert tld.main(["--asr", str(root / "whisper"), "--out", str(tmp_path),
                     "--device", CPU]) == 0
    assert (tmp_path / "asr" / "params.safetensors").exists()
    from expressive_speech_translation_tpu_torch.models import seamless as tsm   # ported: bakes
    scfg = tsm.SeamlessConfig.toy()
    src = em.write_seamless(tmp_path / "seamless-src", tsm.init_seamless(0, scfg, CPU), scfg,
                            text_lang_ids={"fra": 300}, vocoder_lang_ids={"fra": 1})
    assert tld.main(["--seamless", str(src), "--out", str(tmp_path / "s"), "--device", CPU]) == 0
    assert (tmp_path / "s" / "seamless" / "params.safetensors").exists()
    with pytest.raises(tld.WeightsNotFoundError, match="OpenVoice"):      # ported: no checkpoint
        tld.main(["--openvoice", str(root), "--out", str(tmp_path / "x"), "--device", CPU])
    assert not (tmp_path / "x").exists()


@pytest.mark.parametrize("tree, error", [
    ({"a": []}, "empty container"), ({"a.b": torch.ones(1)}, "joins keys with dots"),
    ({"0": torch.ones(1)}, "list indices"), ({"a": 1.0}, "not a tensor")])
def test_the_flat_layout_refuses_what_it_cannot_rebuild(tmp_path, tree, error):
    with pytest.raises((ValueError, TypeError), match=error):
        tld.save_converted(tree, tcv.SpeechLMConfig(), tmp_path)


# -------------------------------------------------------------- EST_MODELS_DIR


def test_a_jax_orbax_bake_is_refused(ckpts, tmp_path, monkeypatch):
    """JAX's ``bake_models`` writes orbax ``params/``: the port names the
    layout and its own bake CLI, and never serves random weights instead."""
    root, _ = ckpts
    jld.bake_models(tmp_path, asr=str(root / "whisper"))
    with pytest.raises(tld.WeightsNotFoundError,
                       match=r"orbax tree.*models\.loaders --asr DIR"):
        tld.load_converted(tmp_path / "asr", twh.WhisperConfig, CPU)
    monkeypatch.setenv("EST_MODELS_DIR", str(tmp_path))
    with pytest.raises(tld.WeightsNotFoundError, match="orbax"):
        torch_engines(device=CPU, dtype=torch.float32)


def test_torch_engines_serves_the_bake(ckpts, baked, monkeypatch):
    """asr, nmt, the official triple and ECAPA come from the bake, with
    their configs; the flags say so."""
    monkeypatch.setenv("EST_MODELS_DIR", str(baked))
    eng = torch_engines(device=CPU, dtype=torch.float32)
    assert not (eng.asr.weightless or eng.nmt.weightless or eng.tts.weightless)
    assert eng.tts.official is not None and not eng.tts.conditioning_weightless
    assert eng.asr.cfg == tld.load_converted(baked / "asr", twh.WhisperConfig, CPU)[1]
    assert eng.nmt.cfg.d_model == 32 and eng.tts.official_cfg == OTINY
    assert eng.tts._ecapa_cfg.embed_dim == 192
    want, _ = tld.load_whisper(ckpts[0] / "whisper", device=CPU)
    assert_trees_equal(eng.asr.params, want)


def test_explicit_keys_win_over_the_bake(baked, monkeypatch):
    monkeypatch.setenv("EST_MODELS_DIR", str(baked))
    cfg = twh.WhisperConfig(d_model=16, encoder_layers=1, decoder_layers=1, heads=2, ffn_dim=32,
                            vocab_size=51_865)
    eng = torch_engines(device=CPU, dtype=torch.float32, asr_cfg=cfg,
                        asr_params=twh.init_whisper(0, cfg, CPU), tts_cfg=TCCFG,
                        tts_params=tcv.init_cosyvoice(0, TCCFG, CPU),
                        tts_ecapa=(tec.init_ecapa(0, tec.EcapaConfig(channels=16, mfa_out=48,
                                                                     bottleneck=8), CPU),
                                   tec.EcapaConfig(channels=16, mfa_out=48, bottleneck=8)))
    assert eng.asr.cfg.d_model == 16 and eng.tts.official is None
    assert eng.tts._ecapa_cfg.channels == 16 and eng.nmt.weightless is False


@pytest.mark.parametrize("layout", ["missing", "empty", "no_config"])
def test_a_directory_without_config_json_serves_random_weights_like_jax(tmp_path, monkeypatch,
                                                                         layout):
    """As in JAX, only stage directories with ``config.json`` are read: a
    missing or empty ``EST_MODELS_DIR`` gives the weightless engines."""
    root = tmp_path / "models"
    if layout != "missing":
        root.mkdir()
    if layout == "no_config":
        (root / "asr").mkdir()
        write_safetensors({"x": torch.ones(1)}, root / "asr" / "params.safetensors")
    monkeypatch.setenv("EST_MODELS_DIR", str(root))
    eng = torch_engines(**ETINY)
    jeng = jax_engines(asr_cfg=jwh.WhisperConfig(**_fields(ETINY["asr_cfg"])),
                       nmt_cfg=jnl.NLLBConfig(**_fields(ETINY["nmt_cfg"])))
    for stage in ("asr", "nmt", "tts"):
        assert getattr(eng, stage).weightless is getattr(jeng, stage).weightless is True
    assert eng.tts.conditioning_weightless is jeng.tts.conditioning_weightless is True


def test_translate_speech_from_the_port_bake_matches_jax_from_its_bake(ckpts, tmp_path,
                                                                       monkeypatch):
    """The same HF Whisper / M2M100 / speechbrain checkpoints and FSQ tree,
    baked by each package into its own layout and served under
    ``EST_MODELS_DIR`` (the native TTS on a shared tree, JAX's key schedule
    injected): the transcripts are token-exact and the audio agrees. Both
    sides serve in f32 with greedy ASR and 12-token budgets: the JAX factory
    builds its engines in bf16 with no key to say otherwise, so its engine
    classes are given these defaults for the test."""
    import functools

    import jax.numpy as jnp

    from expressive_speech_translation_tpu.pipeline import jax_engines as je

    for name, extra in (("JaxWhisperAsr", dict(max_new_tokens=12, temperatures=(0.0,))),
                        ("JaxNllbNmt", dict(max_new_tokens=12)), ("JaxCosyVoiceTts", {})):
        monkeypatch.setattr(je, name, functools.partial(getattr(je, name), dtype=jnp.float32,
                                                        **extra))
    root, _ = ckpts
    st_tree = _np(host_init(jst.init_speech_tokenizer, 6, STCFG))
    jdir = tmp_path / "jax"
    jld.bake_models(jdir, asr=str(root / "whisper"), nmt=str(root / "nllb"))
    jld.save_converted(jec.from_speechbrain_state_dict(
        torch.load(root / "ecapa" / "embedding_model.ckpt"), ECFG), ECFG, jdir / "ecapa")
    jld.save_converted(st_tree, STCFG, jdir / "speech_tokenizer")
    pdir = tmp_path / "port"
    tld.bake_models(pdir, asr=str(root / "whisper"), nmt=str(root / "nllb"),
                    ecapa=str(root / "ecapa"), device=CPU)
    tld.save_converted(tst.from_jax_params(st_tree, CPU), tst.SpeechTokenizerConfig(
        **_fields(STCFG)), pdir / "speech_tokenizer")

    from expressive_speech_translation_tpu.models import cosyvoice as jcv

    tts_tree = _np(host_init(jcv.init_cosyvoice, 8, CCFG))
    lang = nllb_placeholder_lang_ids(NMT_VOCAB)
    monkeypatch.setenv("EST_MODELS_DIR", str(jdir))
    jeng = jax_engines(tts_cfg=CCFG, tts_params=tts_tree, lang_code_to_id=lang)
    monkeypatch.setenv("EST_MODELS_DIR", str(pdir))
    eng = torch_engines(device=CPU, dtype=torch.float32, tts_cfg=TCCFG,
                        tts_params=tcv.from_jax_params(tts_tree, CPU), tts_noise=JaxCallNoise,
                        lang_code_to_id=lang)
    for e in (jeng, eng):
        assert not (e.asr.weightless or e.nmt.weightless or e.tts.conditioning_weightless)
    # greedy only: the ladder's sampled rungs draw from each package's own generator
    eng.asr.temperatures = (0.0,)
    eng.asr.max_new_tokens = eng.nmt.max_new_tokens = 12
    x = _speechlike(2.0, seed=5)
    want = JaxBackend(jeng).translate_speech(x, "eng", "fra")
    got = CascadedBackend(eng).translate_speech(x, "eng", "fra")
    assert got["transcripts"] == want["transcripts"]
    assert want["transcripts"]["target"]
    assert got["audio"].shape == want["audio"].shape
    np.testing.assert_allclose(got["audio"], want["audio"], atol=1e-4)


# --------------------------------------------------------------- the emitters


@pytest.mark.parametrize("family", ["whisper", "nllb"])
def test_the_emitters_write_the_transformers_state_dicts(family):
    """Same keys and shapes as the transformers model's ``state_dict()`` at
    toy widths, and the converter reads the emitted dict back bit for bit."""
    if family == "whisper":
        hf, cfg = _hf_whisper(), twh.WhisperConfig(d_model=32, encoder_layers=1,
                                                    decoder_layers=1, heads=2, ffn_dim=64)
        params = twh.init_whisper(3, cfg, CPU)
        state, conv = em.whisper_hf_state_dict(params, cfg), twh.from_hf_state_dict
        hf_cfg = em.whisper_hf_config(cfg)
    else:
        hf, cfg = _hf_nllb(), tnl.NLLBConfig(d_model=32, encoder_layers=1, decoder_layers=1,
                                             heads=2, ffn_dim=64, vocab_size=NMT_VOCAB,
                                             max_positions=64)
        params = tnl.init_nllb(3, cfg, CPU)
        state, conv = em.nllb_hf_state_dict(params, cfg), tnl.from_hf_state_dict
        hf_cfg = em.nllb_hf_config(cfg)
    want = hf.state_dict()
    assert set(state) == set(want)
    for k, v in want.items():
        assert state[k].shape == v.shape and state[k].dtype == v.dtype, k
    assert_trees_equal(conv(state, cfg, CPU), params)
    for k, v in hf_cfg.items():
        if k not in ("architectures", "torch_dtype"):
            assert getattr(hf.config, k) == v, k


def test_the_ecapa_and_llm_emitters_round_trip():
    """speechbrain's ECAPA naming (the mirror's ``state_dict()`` keys and
    shapes) and the official ``llm.pt`` naming (the converter tests' keys),
    each read back by its converter bit for bit."""
    cfg = tec.EcapaConfig(**_fields(ECFG))
    params = tec.init_ecapa(4, cfg, CPU)
    state = em.ecapa_speechbrain_state_dict(params, cfg)
    want = _speechbrain_ecapa().state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {k: tuple(v.shape)
                                                             for k, v in want.items()}
    assert_trees_equal(tec.from_speechbrain_state_dict(state, cfg, CPU), params)
    lm = tco.init_official_tts(2, OTINY, CPU)["lm"]
    state = em.cosyvoice_llm_state_dict(lm, OTINY.lm)
    from test_torch_official import JTINY

    assert set(state) == set(_llm_state(JTINY.lm))
    assert_trees_equal(tcv.from_cosyvoice_llm_state_dict(state, OTINY.lm, CPU), lm)
