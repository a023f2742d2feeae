"""The ablation variants of ``python -m gvl_tpu_torch.kernel_ablation`` still
apply to the committed kernel sources (the tool itself runs on the card)."""

import pytest

from gvl_tpu_torch import kernel_ablation as ka


@pytest.mark.parametrize("source,variant", [
    (source, name) for source, variants in ka.VARIANTS.items() for name in variants])
def test_each_ablation_edits_its_source_once(source, variant):
    original = (ka._build.CSRC_DIR / source).read_text()
    text = ka.edited(source, ka.VARIANTS[source][variant])
    assert text != original


def test_an_edit_that_no_longer_applies_raises():
    with pytest.raises(ValueError, match="occurs 0 times"):
        ka.edited("chunk_attention.cu", [("no such text", "")])
