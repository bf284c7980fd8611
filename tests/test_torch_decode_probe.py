"""The decode probe (``obs/decode_probe.py``) without a card: each cut inserts
its code once, before an anchor that ``csrc/decode.cu`` holds exactly once and
after the definitions it replaces, so a change to the kernels that would make
a cut miss fails here and not on the card; and the probe refuses to run
without CUDA."""

import pytest
import torch

from expressive_speech_translation_tpu_torch.obs import decode_probe
from expressive_speech_translation_tpu_torch.ops import build

SOURCE = (build.CSRC_DIR / "decode.cu").read_text()


@pytest.mark.parametrize("name", sorted(decode_probe.CUTS))
def test_decode_probe_cut_inserts_its_code_once(name):
    cuts = decode_probe.CUTS[name]
    got = decode_probe.variant_source(SOURCE, cuts)
    for anchor, code in cuts:
        assert got.count(code + anchor) == 1
        got = got.replace(code, "", 1)
    assert got == SOURCE


def test_decode_probe_refuses_a_missing_anchor():
    with pytest.raises(ValueError, match="anchors need updating"):
        decode_probe.variant_source(SOURCE.replace(decode_probe.BEFORE_KERNEL, ""),
                                    decode_probe.CUTS["no-norm"])


def test_decode_probe_macros_follow_what_they_replace():
    """mma_bf16, ldsm_x4(_t), griddep_wait and cluster_arrive_relaxed are
    defined before the first anchor and used only after it; normed_slice,
    norm_prefetch and cluster_reduce are defined before the second and called
    after it, in the
    stream kernel; the launch attribute the no-pdl cut renames is used only in
    the host code after the third, and so is the stream kernel's name, which the
    empty cut renames."""
    helpers = SOURCE.index(decode_probe.AFTER_HELPERS)
    kernel = SOURCE.index(decode_probe.BEFORE_KERNEL)
    host = SOURCE.index(decode_probe.BEFORE_HOST)
    assert helpers < kernel < host
    for fn in ("void mma_bf16(", "void ldsm_x4(", "void ldsm_x4_t(", "void griddep_wait(",
               "void cluster_arrive_relaxed("):
        assert SOURCE.index(fn) < helpers
    for use in ("mma_bf16(acc", "ldsm_x4_t(stage", "ldsm_x4(stage", "griddep_wait();"):
        assert SOURCE.index(use) > helpers
    for fn in ("void normed_slice(", "void norm_prefetch(", "void cluster_reduce("):
        assert helpers < SOURCE.index(fn) < kernel
    assert kernel < SOURCE.index("normed_slice<T>(a, NBP") < host
    assert kernel < SOURCE.index("norm_prefetch<T>(a, d0, pf)") < host
    assert kernel < SOURCE.index("cluster_reduce<T, G>(a, wpart") < host
    assert kernel < SOURCE.index("cluster_arrive_relaxed();") < host
    attr = "cudaLaunchAttributeProgrammaticStreamSerialization"
    assert SOURCE.count(attr) == 1 and SOURCE.index(attr) > host
    # the empty cut renames the stream kernel where the host launches it
    assert SOURCE.index("ln_stream_kernel(StreamArgs a") < host
    assert SOURCE.count("ln_stream_kernel<T, G, NT>") == 2
    assert SOURCE.index("ln_stream_kernel<T, G, NT>") > host


def test_decode_probe_keeps_the_operands_of_a_cut_product_live():
    """The no-mma stand-in adds every operand into the sums, so ptxas keeps
    the loads that feed it; the stream cut drops the shared-memory reads too."""
    assert "(a)[0] ^ (a)[1] ^ (a)[2] ^ (a)[3] ^ (b0) ^ (b1)" in decode_probe.NO_MMA
    (_, code), = decode_probe.CUTS["stream"]
    assert code == decode_probe.NO_MMA + decode_probe.NO_LDSM
    assert set(decode_probe.MATVEC_CUTS) < set(decode_probe.CUTS)


def test_decode_probe_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert decode_probe.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
