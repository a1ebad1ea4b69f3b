"""The card scripts that build a kernel with text substitutions
(``kernels/<kernel>/variants.py``, ``kernels/paged_attention/timeline.py``)
need each substitution's anchor exactly once in the CUDA source as it
stands, or they raise on the card: checked here, where nothing is built."""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_prefill import variants as k3_variants  # noqa: E402
from repro_torch.kernels.paged_attention import timeline as k1_timeline  # noqa: E402
from repro_torch.kernels.paged_attention import variants as k1_variants  # noqa: E402
from repro_torch.kernels.ssd import variants as k4_variants  # noqa: E402


@pytest.mark.parametrize("source,variants", [
    ("paged_attention.cu", k1_variants.VARIANTS),
    ("paged_attention.cu", k1_timeline.VARIANTS),
    ("flash_prefill.cu", k3_variants.VARIANTS),
    ("ssd.cu", k4_variants.VARIANTS),
    ("ssd.cu", k4_variants.DIAGNOSTICS),
], ids=["K1", "K1-timeline", "K3", "K4", "K4-diagnostics"])
def test_variant_substitutions_apply_to_the_source(source, variants):
    src = (build.CSRC / source).read_text()
    for name, subs in variants.items():
        changed = build.variant_source(src, subs)
        assert (changed != src) == bool(subs), name


def test_variant_source_rejects_a_missing_or_repeated_anchor():
    with pytest.raises(ValueError, match="found 0 times"):
        build.variant_source("int a;", [("int b;", "int c;")])
    with pytest.raises(ValueError, match="found 2 times"):
        build.variant_source("int a; int a;", [("int a;", "int c;")])
