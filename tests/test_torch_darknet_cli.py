"""The port's darknet detector verbs (`betapose_tpu_torch/tools/
darknet_cli.py`: test, valid, recall, map, calc_anchors, demo), its MJPEG
server, `tools/detect.py` and `entry()`, against the JAX package's, on the
CPU, as tests/test_darknet_cli.py drives the JAX CLI: a tiny cfg at reso
64, six 64x64 frames with a bright square each, and one `.weights` file
written by the JAX package that both CLIs load.

Both CLIs run the folded network on bf16 inputs with float32 sums and one
rounding per layer; the port's layer is held to JAX's at 1 bf16 ulp
(tests/test_torch_yolo_bf16.py).  One ulp of a raw head value t moves a
box centre by at most 0.25 * 2^-8 * |t| cells and a box side by a factor
exp(2^-8 * |t|), so the detections are held to: the same count and
classes per image, scores within 2e-3 and box corners within 0.5 px of
the 64x64 image (measured: far inside both)."""

import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402

from betapose_tpu.models import yolov3 as jax_yolo  # noqa: E402
from betapose_tpu.tools import darknet_cli as jax_cli  # noqa: E402
from betapose_tpu_torch.tools import darknet_cli as port_cli  # noqa: E402
from betapose_tpu_torch.tools import detect as port_detect  # noqa: E402
from betapose_tpu_torch.tools import http_stream  # noqa: E402
from tests.test_darknet_cli import TINY_NET_CFG  # noqa: E402

SCORE_TOL = 2e-3
BOX_TOL_PX = 0.5
THRESH = 0.3


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tests/test_darknet_cli.py's tiny dataset, and a .weights file of
    the JAX package's seeded init (batch norm with non-trivial statistics
    so the fold is exercised)."""
    d = tmp_path_factory.mktemp("port_darknet_cli")
    img_dir = d / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        img = rng.integers(0, 60, (64, 64, 3), dtype=np.uint8)
        x, y = 16 + 4 * i % 20, 20 + 3 * i % 18
        img[y:y + 20, x:x + 20] = 220
        p = str(img_dir / f"{i:04d}.png")
        cv2.imwrite(p, img)
        cx, cy, w, h = (x + 10) / 64, (y + 10) / 64, 20 / 64, 20 / 64
        with open(str(img_dir / f"{i:04d}.txt"), "w") as f:
            f.write(f"0 {cx} {cy} {w} {h}\n")
        paths.append(p)
    lst = d / "all.txt"
    lst.write_text("".join(p + "\n" for p in paths))
    names = d / "obj.names"
    names.write_text("thing\n")
    data = d / "obj.data"
    data.write_text(f"classes = 1\ntrain = {lst}\nvalid = {lst}\n"
                    f"names = {names}\nbackup = {d / 'backup'}\n")
    cfg = d / "net.cfg"
    cfg.write_text(TINY_NET_CFG)
    spec = jax_yolo.build_spec(TINY_NET_CFG)
    params = jax_yolo.init_params(jax.random.PRNGKey(0), spec)
    prng = np.random.default_rng(1)
    for p in params:
        if "bn_scale" in p:
            n = p["bn_scale"].shape
            p.update(bn_scale=prng.uniform(0.5, 1.5, n).astype(np.float32),
                     bn_bias=prng.normal(0, 0.1, n).astype(np.float32),
                     bn_mean=prng.normal(0, 0.1, n).astype(np.float32),
                     bn_var=prng.uniform(0.5, 2.0, n).astype(np.float32))
    weights = str(d / "jax.weights")
    jax_yolo.save_darknet_weights(spec, params, weights)
    return {"data": str(data), "cfg": str(cfg), "weights": weights,
            "dir": d, "paths": paths}


def assert_same_dets(port, ref):
    """Per image: the same count and classes, scores within SCORE_TOL,
    box corners within BOX_TOL_PX."""
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        p, r = np.asarray(p), np.asarray(r)
        assert p.shape == r.shape
        np.testing.assert_array_equal(p[:, 5], r[:, 5])
        np.testing.assert_allclose(p[:, 4], r[:, 4], rtol=0, atol=SCORE_TOL)
        np.testing.assert_allclose(p[:, :4], r[:, :4], rtol=0,
                                   atol=BOX_TOL_PX)


def port_dets(tiny, paths, thresh=THRESH):
    model, reso = port_cli._load_model(tiny["cfg"], tiny["weights"],
                                       device="cpu")
    return port_cli._detect_images(model, reso, paths, thresh)


def jax_dets(tiny, paths, thresh=THRESH, nms_thresh=0.45):
    spec, params, reso = jax_cli._load_model(tiny["cfg"], tiny["weights"])
    return jax_cli._detect_images(spec, params, reso, paths, thresh,
                                  nms_thresh)


def test_detections_match_the_jax_cli(tiny):
    port, ref = port_dets(tiny, tiny["paths"]), jax_dets(tiny, tiny["paths"])
    assert sum(len(r) for r in ref) > 0
    assert_same_dets(port, ref)


def test_test_verb(tiny, capsys):
    argv = ["detector", "test", tiny["data"], tiny["cfg"], tiny["weights"],
            tiny["paths"][0], "-thresh", str(THRESH)]
    port = port_cli.main(argv + ["-device", "cpu"])
    port_out = capsys.readouterr().out
    ref = jax_cli.cmd_test(tiny["data"], tiny["cfg"], tiny["weights"],
                           tiny["paths"][0], thresh=THRESH)
    ref_out = capsys.readouterr().out
    assert_same_dets([port], [ref])
    assert port_out.count("thing: ") == ref_out.count("thing: ") == len(ref)


def test_valid_verb_writes_the_jax_clis_files(tiny, tmp_path):
    port = port_cli.cmd_valid(tiny["data"], tiny["cfg"], tiny["weights"],
                              thresh=THRESH, out_dir=str(tmp_path / "port"),
                              device="cpu")
    jax_cli.cmd_valid(tiny["data"], tiny["cfg"], tiny["weights"],
                      thresh=THRESH, out_dir=str(tmp_path / "jax"))
    name = "comp4_det_test_thing.txt"
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax") \
        == [name]
    rows = [[ln.split() for ln in open(tmp_path / w / name)]
            for w in ("port", "jax")]
    assert len(rows[0]) == len(rows[1]) == sum(len(d) for d in port) > 0
    for a, b in zip(*rows):
        assert a[0] == b[0]
        np.testing.assert_allclose(float(a[1]), float(b[1]), atol=SCORE_TOL)
        np.testing.assert_allclose([float(v) for v in a[2:]],
                                   [float(v) for v in b[2:]],
                                   atol=BOX_TOL_PX)


@pytest.mark.parametrize("verb", ["recall", "map"])
def test_recall_and_map_verbs(tiny, verb):
    """The same recall and mAP as the JAX CLI (they read the detections
    only through IoU > 0.5 / 0.25 and the score order)."""
    args = (tiny["data"], tiny["cfg"], tiny["weights"])
    if verb == "recall":
        port = port_cli.cmd_recall(*args, thresh=THRESH, device="cpu")
        ref = jax_cli.cmd_recall(*args, thresh=THRESH)
    else:
        port = port_cli.cmd_map(*args, iou_thresh=0.25, thresh=THRESH,
                                device="cpu")
        ref = jax_cli.cmd_map(*args, iou_thresh=0.25, thresh=THRESH)
    assert 0.0 <= port <= 1.0
    assert port == pytest.approx(ref, abs=1e-12)
    via_main = port_cli.main(["detector", verb, *args, "-device", "cpu"])
    assert 0.0 <= via_main <= 1.0


def test_calc_anchors_writes_the_jax_clis_anchors(tiny, tmp_path, capsys):
    for cli, name in ((port_cli, "port"), (jax_cli, "jax")):
        rc = cli.cmd_calc_anchors(tiny["data"], num_of_clusters=2, width=416,
                                  height=416,
                                  out_file=str(tmp_path / f"{name}.txt"))
        assert rc == 0
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()
    out = capsys.readouterr().out
    assert out.count("avg IoU = ") == 2
    assert isinstance(port_cli.main(["detector", "calc_anchors",
                                     tiny["data"]]), port_cli.CliError)


class RecordingStreamer(http_stream.MjpegStreamer):
    """The MJPEG server, counting the frames the demo writes to it."""
    written = []

    def write_rgb(self, frame):
        RecordingStreamer.written.append(frame.shape)
        return super().write_rgb(frame)


@pytest.mark.parametrize("max_frames", [None, 5])
def test_demo_writes_one_frame_per_video_frame(tiny, tmp_path, monkeypatch,
                                               max_frames):
    """`detector demo` over a 7-frame video at batch 3: one overlay frame
    per video frame (the padded tail of the last batch is dropped) into
    the output video and the MJPEG server, or max_frames of them."""
    video = str(tmp_path / "in.avi")
    wr = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"XVID"), 10,
                         (64, 64))
    rng = np.random.default_rng(1)
    for _ in range(7):
        frame = rng.integers(0, 60, (64, 64, 3), dtype=np.uint8)
        frame[20:40, 16:36] = 220
        wr.write(frame)
    wr.release()
    monkeypatch.setattr(http_stream, "MjpegStreamer", RecordingStreamer)
    RecordingStreamer.written = []
    out_video = str(tmp_path / "render.avi")
    flags = ["-out_filename", out_video, "-http_port", "0", "-thresh",
             str(THRESH), "-device", "cpu"]
    if max_frames:
        flags += ["-max_frames", str(max_frames)]
    n = port_cli.cmd_demo(tiny["data"], tiny["cfg"], tiny["weights"],
                          video=video, thresh=THRESH, out_filename=out_video,
                          batch=3, max_frames=max_frames, http_port=0,
                          device="cpu")
    want = max_frames or 7
    assert n == want
    assert RecordingStreamer.written == [(64, 64, 3)] * want
    cap = cv2.VideoCapture(out_video)
    count = 0
    while cap.read()[0]:
        count += 1
    assert count == want
    RecordingStreamer.written = []
    assert port_cli.main(["detector", "demo", tiny["data"], tiny["cfg"],
                          tiny["weights"], video, *flags]) == want


# ---- the MJPEG server (a copy of the JAX package's) ---------------------

def _read_parts(client, n):
    client.settimeout(5)
    buf = b""
    while buf.count(b"--mjpegstream") < n:
        chunk = client.recv(65536)
        if not chunk:
            break
        buf += chunk
    return buf


def test_mjpeg_protocol_and_frames():
    """multipart/x-mixed-replace with boundary 'mjpegstream', a
    Content-Length per part, decodable JPEGs (http_stream.cpp:167-182)."""
    streamer = http_stream.MjpegStreamer(0, quality=90)
    client = socket.create_connection(("127.0.0.1", streamer.port),
                                      timeout=5)
    client.sendall(b"GET / HTTP/1.0\r\n\r\n")
    rng = np.random.default_rng(0)
    for _ in range(2):
        streamer.write_rgb(rng.integers(0, 255, (32, 48, 3), dtype=np.uint8))
    buf = _read_parts(client, 2)
    client.close()
    streamer.close()
    head, _, rest = buf.partition(b"\r\n\r\n")
    assert b"HTTP/1.0 200 OK" in head
    assert (b"Content-Type: multipart/x-mixed-replace; "
            b"boundary=mjpegstream") in head
    decoded = 0
    for part in rest.split(b"--mjpegstream"):
        if b"Content-Length:" not in part:
            continue
        ph, _, body = part.partition(b"\r\n\r\n")
        n = int(ph.split(b"Content-Length:")[1].split(b"\r\n")[0])
        assert b"Content-Type: image/jpeg" in ph
        img = cv2.imdecode(np.frombuffer(body[:n], np.uint8),
                           cv2.IMREAD_COLOR)
        assert img is not None and img.shape == (32, 48, 3)
        decoded += 1
    assert decoded == 2


def test_mjpeg_dead_client_dropped():
    streamer = http_stream.MjpegStreamer(0)
    client = socket.create_connection(("127.0.0.1", streamer.port),
                                      timeout=5)
    frame = np.zeros((16, 16, 3), np.uint8)
    streamer.write_rgb(frame)
    assert len(streamer._clients) == 1
    client.close()
    for _ in range(3):
        streamer.write_rgb(frame)
    assert len(streamer._clients) == 0
    streamer.close()


def test_mjpeg_is_the_jax_packages_server():
    """The copy's wire constants are the JAX package's."""
    from betapose_tpu.tools import http_stream as jax_stream
    assert http_stream._MAIN_HEADER == jax_stream._MAIN_HEADER


# ---- detect.py and entry() ---------------------------------------------------

def test_detect_writes_det_images(tiny, tmp_path):
    """detect.py over an image directory: one `det_<name>` per image, the
    JAX CLI's detections."""
    import shutil
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for p in tiny["paths"][:3]:
        shutil.copy(p, imgs)
    out = tmp_path / "det"
    port = port_detect.main(["--images", str(imgs), "--det", str(out),
                             "--cfg", tiny["cfg"], "--weights",
                             tiny["weights"], "--confidence", str(THRESH),
                             "--num_classes", "1", "--reso", "64",
                             "--device", "cpu"])
    names = sorted(os.listdir(imgs))
    assert sorted(os.listdir(out)) == ["det_" + f for f in names]
    for f in names:
        assert cv2.imread(str(out / ("det_" + f))).shape == (64, 64, 3)
    assert_same_dets(port, jax_dets(tiny, [str(imgs / f) for f in names],
                                    nms_thresh=0.4))   # detect.py's default


def test_entry_step_matches_graft_entry(monkeypatch):
    """The port's `entry()` on the CPU against `__graft_entry__.entry()`,
    at a small size (the tiny two-head YOLO of tests/test_torch_pipeline.py
    at reso 64, FastPose-resnet50 with 50 keypoints on 64x32 crops, float32,
    confidence 0) on the same weights (the JAX package's, loaded into the
    port's networks) and the same seeded frames: det_valid equal, boxes
    within 1e-3 px, keypoints within 1e-3 px, keypoint scores within 1e-4
    relative, and poses within 1e-4 m of ADD over the keypoint model."""
    import __graft_entry__ as graft
    import jax.numpy as jnp
    from betapose_tpu.eval import pipeline as jax_pipe
    from betapose_tpu.models import kpd as jax_kpd
    from betapose_tpu_torch import entry as port_entry
    from betapose_tpu_torch.eval import pipeline as port_pipe
    from betapose_tpu_torch.models import kpd as port_kpd
    from betapose_tpu_torch.models import yolov3 as port_yolo
    from tests.test_torch_kpd import random_kpd_params
    from tests.test_torch_pipeline import TINY_YOLO_CFG

    kw = dict(reso=64, inp_h=64, inp_w=32, out_h=16, out_w=8,
              compute_dtype="float32", confidence=0.0)
    spec_j = jax_yolo.build_spec(TINY_YOLO_CFG)
    yolo_j = jax_yolo.fold_bn(spec_j, jax_yolo.init_params(
        jax.random.PRNGKey(0), spec_j))
    kpd_j = random_kpd_params(50, "resnet50", 1)
    monkeypatch.setattr(graft, "_small_pipeline_pieces", lambda: (
        jax_pipe.make_pose_step(spec_j, jax_pipe.PipelineConfig(
            **kw, pallas_decode=False, s2d_stem=False)), yolo_j, kpd_j))
    jfn, jargs = graft.entry()

    fn, args = port_entry.entry(device="cpu", yolo_cfg=TINY_YOLO_CFG,
                                cfg=port_pipe.PipelineConfig(**kw),
                                arch="resnet50")
    yolo, kpd = args[0], args[1]
    yolo.load_state_dict(port_yolo.params_from_jax(
        port_yolo.build_spec(TINY_YOLO_CFG),
        [{k: np.asarray(v) for k, v in p.items()} for p in yolo_j],
        64).state_dict())
    fp = port_kpd.FastPose(50, "resnet50")
    fp.load_state_dict(port_kpd.state_dict_from_jax(kpd_j))
    kpd.load_state_dict(port_kpd.fold_bn(fp).state_dict())

    frames = np.random.default_rng(3).integers(0, 256, (4, 480, 640, 3),
                                               dtype=np.uint8)
    assert jargs[2].shape == tuple(args[2].shape) == frames.shape
    np.testing.assert_allclose(np.asarray(jargs[3]), args[3].numpy())
    np.testing.assert_allclose(np.asarray(jargs[4]), args[4].numpy())
    ref = {k: np.asarray(v) for k, v in jfn(
        *jargs[:2], jnp.asarray(frames), *jargs[3:]).items()}
    out = {k: v.numpy() for k, v in fn(
        yolo, kpd, torch.from_numpy(frames), *args[3:]).items()}
    assert set(out) <= set(ref)
    np.testing.assert_array_equal(out["det_valid"], ref["det_valid"])
    assert out["det_valid"].all()
    np.testing.assert_allclose(out["boxes"], ref["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(out["keypoints"], ref["keypoints"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(out["kp_scores"], ref["kp_scores"], rtol=1e-4,
                               atol=1e-6)
    kp3d = args[3].numpy()
    for i in range(len(frames)):
        a = kp3d @ out["cam_R"][i].T + out["cam_t"][i]
        b = kp3d @ ref["cam_R"][i].T + ref["cam_t"][i]
        assert np.linalg.norm(a - b, axis=1).mean() < 1e-4, i
