"""The port's pose-NMS (`betapose_tpu_torch/ops/pose_nms.py`) against the
JAX package's (`betapose_tpu/ops/pose_nms.py`) on the CPU:

- the host loop `pose_nms` (a float64 numpy copy) gives the same result
  dicts to 1e-12;
- the batched device loop `pose_nms_device` picks the same proposal (pick
  box and objectness exactly equal), with keypoints, scores and proposal
  score within rtol 1e-5, on the candidate sets of
  tests/test_pose_nms_device.py, with and without `extra=`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from betapose_tpu.ops import pose_nms as jax_pnms  # noqa: E402
from betapose_tpu_torch.ops import pose_nms as port_pnms  # noqa: E402
from tests.test_pose_nms_device import _random_candidates  # noqa: E402

SHAPES = [(4, 50), (8, 50), (3, 26)]


def _cases():
    """name -> (bboxes, bscores, preds, scores, valid) numpy, one frame."""
    cases = {}
    for seed in range(5):
        for n, k in SHAPES:
            cases[f"seed{seed}_n{n}_k{k}"] = _random_candidates(
                np.random.default_rng(seed), n, k, cluster=seed % 2 == 0)
    c = list(_random_candidates(np.random.default_rng(7), 6, 50, n_valid=3))
    c[3][4], c[1][4] = 0.99, 1.0          # an invalid slot scores best
    cases["invalid_slots"] = tuple(c)
    cases["all_invalid"] = _random_candidates(np.random.default_rng(8), 4, 50,
                                              n_valid=0)
    c = list(_random_candidates(np.random.default_rng(9), 4, 50))
    c[3] = np.random.default_rng(9).uniform(0.01, 0.25, c[3].shape).astype(
        np.float32)
    cases["all_below_threshold"] = tuple(c)
    c = list(_random_candidates(np.random.default_rng(10), 4, 50))
    c[3][:, ::3] = 0.0
    cases["zero_scores"] = tuple(c)
    cases["far_apart"] = _random_candidates(np.random.default_rng(11), 4, 50,
                                            cluster=False)
    c = list(_random_candidates(np.random.default_rng(12), 4, 26))
    for i in (1, 2, 3):                   # identical candidates: equal
        c[0][i], c[2][i], c[3][i] = c[0][0], c[2][0], c[3][0]   # human scores
    cases["tied_candidates"] = tuple(c)
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_loop_matches_jax(name):
    bboxes, bscores, preds, scores, valid = CASES[name]
    v = valid if valid.any() else np.ones_like(valid)
    args = (bboxes[v], bscores[v], preds[v], scores[v][..., None])
    ref = jax_pnms.pose_nms(*args)
    out = port_pnms.pose_nms(*args)
    assert len(out) == len(ref)
    for r, o in zip(ref, out):
        assert set(o) == set(r)
        for key in r:
            np.testing.assert_allclose(np.asarray(o[key]), np.asarray(r[key]),
                                       rtol=1e-12, atol=0, err_msg=key)


def _jax_device(bboxes, bscores, preds, scores, valid, extra=None):
    args = [jnp.asarray(a) for a in (bboxes, bscores, preds, scores, valid)]
    out = jax_pnms.pose_nms_device(
        *args, extra=None if extra is None else jnp.asarray(extra))
    return [np.asarray(o) for o in out]


def _check_device(case_list, extras=None):
    """The port's batched loop over the stacked cases against JAX per
    case."""
    stack = [torch.from_numpy(np.stack([c[i] for c in case_list]))
             for i in range(5)]
    extra = None if extras is None else torch.from_numpy(np.stack(extras))
    out = [o.numpy() for o in port_pnms.pose_nms_device(*stack, extra=extra)]
    for b, case in enumerate(case_list):
        ref = _jax_device(*case, extra=None if extras is None else extras[b])
        assert len(out) == len(ref)
        kp, sc, prop, pbox, pobj, ok, *merged = [o[b] for o in out]
        assert bool(ok) == bool(ref[5])
        # the same pick, attributed to the same candidate
        np.testing.assert_array_equal(pbox, ref[3])
        assert pobj == ref[4]
        np.testing.assert_allclose(kp, ref[0], rtol=1e-5)
        np.testing.assert_allclose(sc, ref[1], rtol=1e-5)
        np.testing.assert_allclose(prop, ref[2], rtol=1e-5)
        if merged:
            np.testing.assert_allclose(merged[0], ref[6], rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_loop_matches_jax(name):
    _check_device([CASES[name]])


@pytest.mark.parametrize("n,k", SHAPES)
def test_device_loop_batched_over_frames_matches_jax(n, k):
    """Five frames in one call, as the pipeline batches them."""
    _check_device([CASES[f"seed{s}_n{n}_k{k}"] for s in range(5)])


@pytest.mark.parametrize("kind", ["scores", "constant", "random"])
def test_device_loop_extra_matches_jax(kind):
    frames = [CASES[f"seed{s}_n4_k50"] for s in range(3)]
    rng = np.random.default_rng(3)
    extras = [{"scores": f[3], "constant": np.full_like(f[3], 0.37),
               "random": rng.uniform(0, 1, f[3].shape).astype(np.float32)}[kind]
              for f in frames]
    _check_device(frames, extras)


def test_argmax_takes_the_first_of_equal_maxima():
    """The device loop relies on `torch.argmax` taking the first of equal
    maxima, all -inf included, as `jnp.argmax` does."""
    inf = float("inf")
    t = torch.tensor([[-inf, -inf, -inf], [0.5, 0.7, 0.7], [-inf, 2.0, 2.0]])
    assert t.argmax(dim=1).tolist() == [0, 1, 1]
    assert np.asarray(jnp.argmax(jnp.asarray(t.numpy()), axis=1)).tolist() \
        == [0, 1, 1]
    # tied candidates: the first is picked and attributed, as in JAX
    bboxes, bscores, preds, scores, valid = CASES["tied_candidates"]
    out = port_pnms.pose_nms_device(*[torch.from_numpy(a[None]) for a in (
        bboxes, bscores, preds, scores, valid)])
    np.testing.assert_array_equal(out[3][0].numpy(), bboxes[0])


def test_single_candidate_form_matches_jax():
    rng = np.random.default_rng(4)
    score = rng.uniform(0, 1, (3, 50, 1)).astype(np.float32)
    score[0, ::4] = 0.0
    score[2] = 0.1
    pred = rng.uniform(0, 300, (3, 50, 2)).astype(np.float32)
    bscore = rng.uniform(0, 1, 3).astype(np.float32)
    out = port_pnms.pose_nms_single(torch.from_numpy(bscore),
                                    torch.from_numpy(pred),
                                    torch.from_numpy(score))
    for b in range(3):
        ref = jax_pnms.pose_nms_single(None, bscore[b], pred[b], score[b])
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o[b].numpy(), np.asarray(r))
