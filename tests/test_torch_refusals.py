"""The port's refusals of later slices cite their ROADMAP.md queue 1 item
by name (not by number, which a re-ordered queue changes): the serving
CLI's `_LATER` flags (--mode animate, --use_prompt_extend), a DiT train
step over a sequence-parallel mesh, and a serving mesh with sp and tp both
above 1."""

import pytest


def _cli_later(flags):
    def case(tmp_path):
        from univid_tpu_torch.cli.inference import main
        with pytest.raises(SystemExit) as e:
            main(flags + ["--output_dir", str(tmp_path)])
        return str(e.value.code)
    return case


def _sp_training(tmp_path):
    from univid_tpu_torch.core.mesh import MeshSpec
    from univid_tpu_torch.train.trainer import make_dit_train_step
    with pytest.raises(NotImplementedError) as e:
        make_dit_train_step(None, None, mesh=MeshSpec(sp=2),
                            rope=(None, None))
    return str(e.value)


def _sp_with_tp(tmp_path):
    from univid_tpu_torch.core.mesh import MeshSpec
    from univid_tpu_torch.parallel.sharding import check_serving_mesh
    with pytest.raises(NotImplementedError) as e:
        check_serving_mesh(MeshSpec(sp=2, tp=2), 2)
    return str(e.value)


CASES = {"WanAnimate": _cli_later(["--mode", "animate"]),
         "prompt extension": _cli_later(["--use_prompt_extend"]),
         "Sequence-parallel training": _sp_training,
         "Sequence and tensor parallelism together": _sp_with_tp}


@pytest.mark.parametrize("item", list(CASES))
def test_refusal_cites_its_roadmap_item_by_name(item, tmp_path):
    msg = CASES[item](tmp_path)
    assert f"ROADMAP.md queue 1: {item}" in msg
    assert "item " not in msg   # no item number
