"""The int4 probe's cuts (``obs/int4_probe.py``) against the kernel source:
each inserts its code once, before an anchor that ``csrc/int4.cu`` holds
exactly once, and after the definitions it replaces, so a change to the
kernel that would make a cut miss fails here and not on the card."""

import pytest

from expressive_speech_translation_tpu_torch.obs import int4_probe
from expressive_speech_translation_tpu_torch.ops import build

SOURCE = (build.CSRC_DIR / "int4.cu").read_text()


@pytest.mark.parametrize("name", sorted(int4_probe.CUTS))
def test_int4_probe_cut_inserts_its_code_once(name):
    cuts = int4_probe.CUTS[name]
    got = int4_probe.variant_source(SOURCE, cuts)
    for anchor, code in cuts:
        assert got.count(code + anchor) == 1
        got = got.replace(code, "", 1)
    assert got == SOURCE


def test_int4_probe_refuses_a_missing_anchor():
    with pytest.raises(ValueError, match="anchors need updating"):
        int4_probe.variant_source(SOURCE.replace(int4_probe.AFTER_HELPERS, ""),
                                  int4_probe.CUTS["stream"])


def test_int4_probe_macros_follow_what_they_replace():
    """dequant2 and mma_bf16 are defined before the first anchor and used
    after it; the bf16 path's finish call comes after the second."""
    helpers = SOURCE.index(int4_probe.AFTER_HELPERS)
    launch = SOURCE.index(int4_probe.BEFORE_LAUNCH)
    for fn in ("unsigned dequant2(", "void mma_bf16("):
        assert SOURCE.index(fn) < helpers
    kernel = SOURCE.index("int4_mma_kernel(Args a)")
    assert helpers < kernel < launch
    assert "dequant2(v01)" in SOURCE[kernel:launch]
    assert "mma_bf16(acc[j][nt]" in SOURCE[kernel:launch]
    assert SOURCE.index("int finish(") < launch
    assert "finish<__nv_bfloat16>(a, splits, st)" in SOURCE[launch:]
