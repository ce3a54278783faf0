"""The port's torch ONNX executor and pose drivers against univid_tpu's
numpy ones on the CPU.

Each graph of chip_smoke.py's op catalogue (the graphs the card run holds
its CUDA session against the CPU one with) and its ViTPose-H-shaped graph
is run by both executors on the same numpy inputs: the same output names,
shapes and dtypes; integer and boolean outputs equal; floating outputs
within 1e-5 relative (rtol 1e-5, atol 1e-6: the summation order of a
product or a reduction). The pose drivers (YOLO box, ViTPose crop + DARK decode, the
133-point split) run both packages on the same graphs and frames.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from test_onnx_rt import (_gaussian_heatmap, _vitpose_fixture,
                          _yolo_fixture, build_model, node)
from univid_tpu.data import onnx_rt as jrt
from univid_tpu.data import pose2d as jpose
from univid_tpu_torch.data import onnx_rt as trt
from univid_tpu_torch.data import pose2d as tpose

torch.set_num_threads(2)

RNG = np.random.default_rng(0)
CASES = chip_smoke.onnx_op_cases()


def run_both(case):
    model, feeds, outs = case
    want = jrt.OnnxSession(model).run(outs, feeds)
    got = trt.OnnxSession(model, device="cpu").run(outs, feeds)
    return got, want


def assert_outputs_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, \
            (g.shape, g.dtype, w.shape, w.dtype)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_numpy_executor(name):
    got, want = run_both(CASES[name])
    assert_outputs_match(got, want)


def test_vitpose_shaped_graph_matches_numpy_executor(tmp_path):
    """One block of the ViTPose-H-shaped graph at full width (1280, 16
    heads, MLP 5120, the deconvolution head to 133 heatmaps of 64x48), and
    the pose driver over it."""
    graph = chip_smoke.vitpose_onnx(1)
    x = RNG.standard_normal((1, 3, 256, 192)).astype(np.float32)
    got, want = run_both((graph, {"input": x}, ["heatmaps"]))
    assert got[0].shape == (1, 133, 64, 48)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5,
                               atol=1e-5 * np.abs(want[0]).max())
    path = tmp_path / "vitpose.onnx"
    path.write_bytes(graph)
    frames = RNG.integers(0, 255, (2, 90, 160, 3)).astype(np.uint8)
    got = tpose.Pose2dDriver(str(path), device="cpu")(frames)
    want = jpose.Pose2dDriver(str(path))(frames)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.body, w.body, rtol=1e-4, atol=1e-3)


def test_shape_plumbing_stays_on_host():
    """Shape results, their Gathers, Concats and Ranges are host int64
    (a device session reads them without a sync): the executor places
    only large floating initializers on the device."""
    model, feeds, _ = CASES["shape_plumbing"]
    sess = trt.OnnxSession(model, device="cpu")
    vals = dict(sess.initializers)
    vals["x"] = torch.from_numpy(feeds["x"])
    for n in sess.graph.nodes:
        for nm, t in zip(n.outputs, trt._run_node(n, vals)):
            vals[nm] = t
    for nm in ("s", "b", "n", "shp", "n0", "ar", "c"):
        assert vals[nm].device.type == "cpu"
    assert vals["shp"].dtype == torch.int64
    small = trt.OnnxSession(build_model(
        [node("Mul", ["x", "w"], ["y"])], [("x", [2, 3])], [("y", [0])],
        [("w", np.ones(3, np.float32))]), device="meta")
    assert small.initializers["w"].device.type == "cpu"


def test_unsupported_op_raises():
    model = build_model([node("FancyCustomOp", ["x"], ["y"])],
                        [("x", [1])], [("y", [1])])
    with pytest.raises(NotImplementedError, match="FancyCustomOp"):
        trt.OnnxSession(model, device="cpu").run(
            ["y"], {"x": np.zeros(1, np.float32)})


def test_nms_indices_equal():
    rng = np.random.default_rng(5)
    boxes = rng.uniform(0, 50, (40, 4))
    scores = rng.uniform(0, 1, 40)
    scores[7] = scores[3]   # a tie keeps index order
    for thr in (0.3, 0.5, 0.7):
        assert trt.nms_indices(boxes, scores, 0.1, thr) == \
            jrt.nms_indices(boxes, scores, 0.1, thr)
    assert trt.nms_indices(np.array([[0, 0, 10, 10], [1, 1, 10, 10],
                                     [20, 20, 5, 5]], np.float64),
                           np.array([0.9, 0.8, 0.7]), 0.05, 0.5) == [0, 2]


# ---------------------------------------------------------------------------
# pose drivers
# ---------------------------------------------------------------------------


def test_decode_heatmaps_matches_jax():
    hm = np.stack([_gaussian_heatmap(64, 48, 20.3 + i, 33.7 - i)
                   for i in range(5)])
    hm[3] = 0.0   # no peak: the -1 path
    center, scale = np.array([100.0, 80.0]), np.array([96.0, 128.0])
    got = tpose.decode_heatmaps(hm, center, scale, unbiased=True)
    want = jpose.decode_heatmaps(hm, center, scale, unbiased=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_wholebody_split_matches_jax():
    kp = RNG.uniform(0, 100, (133, 3)).astype(np.float32)
    got = tpose.wholebody_to_pose_meta(kp)
    want = jpose.wholebody_to_pose_meta(kp)
    for part in ("body", "lhand", "rhand", "face"):
        np.testing.assert_array_equal(getattr(got, part),
                                      getattr(want, part))


def test_pose2d_driver_matches_jax(tmp_path):
    path = _vitpose_fixture(tmp_path)
    det = _yolo_fixture(tmp_path)
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 40, (3, 128, 96, 3)).astype(np.uint8)
    frames[:, 40:56, 30:42, :] = 255
    got = tpose.Pose2dDriver(path, det, device="cpu")(frames)
    want = jpose.Pose2dDriver(path, det)(frames)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for part in ("body", "lhand", "rhand", "face"):
            np.testing.assert_allclose(getattr(g, part), getattr(w, part),
                                       rtol=1e-5, atol=1e-4)


def test_yolo_detector_matches_jax(tmp_path):
    path = _yolo_fixture(tmp_path)
    img = np.random.default_rng(2).integers(0, 255, (480, 640, 3),
                                            np.uint8)
    got = tpose.YoloDetector(path, device="cpu")(img)
    want = jpose.YoloDetector(path)(img)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[4] == pytest.approx(0.9)


def test_session_factory_seam(tmp_path):
    """An injected factory (an onnxruntime session) replaces OnnxSession."""
    made = []

    def factory(p):
        made.append(p)
        return trt.OnnxSession(p, device="cpu")

    drv = tpose.Pose2dDriver(_vitpose_fixture(tmp_path),
                             session_factory=factory)
    assert len(made) == 1 and drv.detector is None
    assert len(drv(np.zeros((1, 64, 48, 3), np.uint8))) == 1
