"""The port's refusals of later slices cite their ROADMAP.md queue 1 item
by name (not by number, which a re-ordered queue changes): BAGEL image
generation in the interleaved inferencer, and the sharded (multi-GPU) DiT
train step."""

import pytest


def _image_generation(tmp_path):
    from univid_tpu_torch.pipelines.interleave import InterleaveInferencer
    with pytest.raises(NotImplementedError) as e:
        InterleaveInferencer.gen_image(None)
    return str(e.value)


def _multi_gpu(tmp_path):
    from univid_tpu_torch.train.trainer import make_dit_train_step
    with pytest.raises(NotImplementedError) as e:
        make_dit_train_step(None, None, mesh=object())
    return str(e.value)


CASES = {"BAGEL image generation": _image_generation,
         "Multi-GPU": _multi_gpu}


@pytest.mark.parametrize("item", list(CASES))
def test_refusal_cites_its_roadmap_item_by_name(item, tmp_path):
    msg = CASES[item](tmp_path)
    assert f"ROADMAP.md queue 1: {item}" in msg
    assert "item " not in msg   # no item number
