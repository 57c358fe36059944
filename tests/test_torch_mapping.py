"""The port's mapping modules vs the reference package on identical maps.

The maps are built by the reference package itself: its front end on a
rendered 512x256 sequence, its ``track_frame_with_map`` for the bindings and
its ``insert_stage`` (``insert_keyframe``) for six keyframes, 16 keyframe /
2048 point / 1024 feature slots; ``from_jax_numpy`` carries them over.
Each ported function then runs on both sides from the same map.

Tolerances, and why:

- integer and bool fields (slots, bindings, validity, covisibility,
  descriptors, counters) are exactly equal: the port scatters, sorts and
  picks ties the reference's way;
- float fields a function only copies or gathers are exactly equal too;
- float fields it computes (point positions, normals, scale bands, poses)
  are within 2e-5 (relative 2e-5 for positions and bands): the same float32
  formulas in another summation order (matmul, einsum, scatter-add of
  normals) differ by a few ulps;
- DLT triangulation solves 3x3 normal equations whose condition number at
  small parallax is ~1e4: one ulp of another summation order moves a point
  by up to ~7e-4 relative (measured), as far as each float32 answer is from
  the float64 DLT, so triangulated points (and the normals and scale bands
  derived from them) are within 2e-3 (absolute metres and relative);
- the grid local BA solves a 48x48 system fifteen times in float32; its
  poses agree within 5e-5 and its points within 1e-3 relative after the
  full solve (each LM step re-linearizes at slightly different floats).
  Those tests, and the mapping stage's, are in ``test_torch_local_ba.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendlv_perception_vision_orbslam2_tpu.models import frontend as jfront
from opendlv_perception_vision_orbslam2_tpu.models import fusion as jfus
from opendlv_perception_vision_orbslam2_tpu.models import map_state as jmap
from opendlv_perception_vision_orbslam2_tpu.models import slam as jslam
from opendlv_perception_vision_orbslam2_tpu.models import triangulation as jtri
from opendlv_perception_vision_orbslam2_tpu.ops import lie as jlie
from opendlv_perception_vision_orbslam2_tpu.optim import ba as jba
from opendlv_perception_vision_orbslam2_tpu.utils import config as jconfig
from opendlv_perception_vision_orbslam2_tpu.utils import synthetic as jsyn
from opendlv_perception_vision_orbslam2_tpu_torch.models import fusion as tfus
from opendlv_perception_vision_orbslam2_tpu_torch.models import map_state as tmap
from opendlv_perception_vision_orbslam2_tpu_torch.models import triangulation as ttri
from opendlv_perception_vision_orbslam2_tpu_torch.ops import hamming as tham
from opendlv_perception_vision_orbslam2_tpu_torch.ops import indexing as tidx
from opendlv_perception_vision_orbslam2_tpu_torch.ops import lie as tlie
from opendlv_perception_vision_orbslam2_tpu_torch.optim import ba as tba
from opendlv_perception_vision_orbslam2_tpu_torch.utils import config as tconfig
from opendlv_perception_vision_orbslam2_tpu_torch.utils.convert import from_jax_numpy, to_numpy

torch.set_num_threads(2)

CAM_CFG = dict(fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0, width=512, height=256,
               fps=10.0)
ORB = dict(n_features=600, max_keypoints=1024, n_levels=4)
CAPS = dict(max_keyframes=16, max_map_points=2048, initial_keyframes=16,
            initial_map_points=2048)
JCFG = jconfig.SystemConfig(camera=jconfig.CameraConfig(**CAM_CFG),
                            orb=jconfig.OrbConfig(**ORB), **CAPS)
TCFG = tconfig.SystemConfig(camera=tconfig.CameraConfig(**CAM_CFG),
                            orb=tconfig.OrbConfig(**ORB), **CAPS)
KF_FRAMES = (0, 2, 4, 6, 8, 10)

# float fields a function computes, and their tolerance (see the docstring)
FLOAT_TOL = dict(atol=2e-5, rtol=2e-5)
TRI_TOL = dict(atol=2e-3, rtol=2e-3)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_port(tree):
    return from_jax_numpy(_np_tree(tree))


def assert_map_equal(port_map, ref_map, tol=FLOAT_TOL, skip=()):
    """Every MapState field: exact for int/bool, within ``tol`` for floats."""
    out = to_numpy(port_map)
    for name in ref_map._fields:
        if name in skip:
            continue
        a, b = np.asarray(getattr(out, name)), np.asarray(getattr(ref_map, name))
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.dtype, b.dtype)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, err_msg=name, **tol)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def built():
    """Six keyframes inserted by the reference package.  Returns
    ``(maps, slots, frames, bindings)``: ``maps[i]`` is the map before the
    i-th insert (``maps[-1]`` after the last), ``frames[i]`` /
    ``bindings[i]`` what the i-th insert was given."""
    lefts, rights, _, _ = jsyn.render_stereo_sequence(JCFG, n_frames=11, n_points=500,
                                                      seed=5, step=0.25)
    m = jmap.empty_map(16, 2048, 1024)
    maps, slots, frames, binds = [], [], [], []
    T = vel = jnp.eye(4, dtype=jnp.float32)
    last, last_b = None, None
    for i in KF_FRAMES:
        cur = jfront.process_stereo(jnp.asarray(lefts[i]), jnp.asarray(rights[i]), JCFG)
        if last is None:
            b = -jnp.ones((1024,), jnp.int32)
        else:
            out = jslam.track_frame_with_map(m, last, last_b, T, vel, cur, JCFG)
            m = jslam.apply_point_counters(m, out.pt_visible_delta, out.pt_found_delta)
            vel = out.T_cw @ jlie.inv_T(T)
            T, b = out.T_cw, out.bindings
            cur = cur._replace(T_cw=T)
        maps.append(_np_tree(m))
        frames.append(_np_tree(cur))
        binds.append(np.asarray(b))
        m, slot, last_b, _ = jslam.insert_stage(m, cur, b, JCFG)
        slots.append(int(slot))
        last = cur
    maps.append(_np_tree(m))
    return maps, slots, frames, binds


# ----------------------------------------------------------------- helpers

def test_popcount_and_topk_match_reference():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    ref = np.asarray(jax.lax.population_count(jnp.asarray(a)))
    out = tham.popcount32(torch.from_numpy(a.view(np.int32))).numpy()
    np.testing.assert_array_equal(out, ref.astype(np.int32))
    w = rng.integers(0, 4, 64).astype(np.int32)          # many ties
    rv, ri = jax.lax.top_k(jnp.asarray(w), 10)
    tv, ti = tidx.topk_stable(torch.from_numpy(w), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


def test_scatter_set_is_last_write_wins_like_reference():
    idx = np.array([3, 1, 3, 0, 1, 3], np.int32)
    vals = np.array([10, 11, 12, 13, 14, 15], np.int32)
    ref = np.asarray(jnp.zeros(5, jnp.int32).at[jnp.asarray(idx)].set(jnp.asarray(vals)))
    out = tidx.scatter_set(torch.zeros(5, dtype=torch.int32), torch.from_numpy(idx),
                           torch.from_numpy(vals))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_lie_mapping_helpers_match_reference():
    rng = np.random.default_rng(1)
    xi = (rng.standard_normal((8, 6)) * 0.3).astype(np.float32)
    T = np.array(jlie.exp_se3(jnp.asarray(xi)))
    T[:, :3, :3] *= 1.01                                   # scale drift
    np.testing.assert_allclose(tlie.orthonormalize_T(torch.from_numpy(T)).numpy(),
                               np.asarray(jlie.orthonormalize_T(jnp.asarray(T))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tlie.det3(torch.from_numpy(T[:, :3, :3])).numpy(),
                               np.linalg.det(T[:, :3, :3]), rtol=1e-5)
    B = rng.standard_normal((16, 3, 3)).astype(np.float32)
    B = B @ B.transpose(0, 2, 1) + np.eye(3, dtype=np.float32)    # symmetric, invertible
    for tfn, jfn in ((tba._inv3x3, jba._inv3x3), (tlie._inv3x3_sym, jlie._inv3x3_sym)):
        np.testing.assert_allclose(tfn(torch.from_numpy(B)).numpy(),
                                   np.asarray(jfn(jnp.asarray(B))), rtol=1e-5, atol=1e-6)
    K = np.array([[320, 0, 256], [0, 320, 128], [0, 0, 1]], np.float32)
    P1 = K @ T[0, :3, :]
    P2 = K @ T[1, :3, :]
    X = rng.uniform(-3, 3, (50, 3)).astype(np.float32) + [0, 0, 12]
    uv1 = np.asarray(jlie.project(jlie.transform_points(jnp.asarray(T[0]), jnp.asarray(X)),
                                  320.0, 320.0, 256.0, 128.0))
    uv2 = np.asarray(jlie.project(jlie.transform_points(jnp.asarray(T[1]), jnp.asarray(X)),
                                  320.0, 320.0, 256.0, 128.0))
    ref = np.asarray(jlie.triangulate_linear(jnp.asarray(P1), jnp.asarray(P2),
                                             jnp.asarray(uv1), jnp.asarray(uv2)))
    out = tlie.triangulate_linear(*(torch.from_numpy(np.ascontiguousarray(x))
                                    for x in (P1, P2, uv1, uv2))).numpy()
    np.testing.assert_allclose(out, ref, **TRI_TOL)
    # both float32 answers sit as far from the float64 DLT as from each other
    X64 = _dlt64(P1, P2, uv1, uv2)
    err_ref, err_out = (np.abs(x - X64).max() for x in (ref, out))
    assert err_out <= 2 * err_ref + 1e-5, (err_out, err_ref)


def _dlt64(P1, P2, uv1, uv2):
    """The same inhomogeneous DLT in float64."""
    def rows(P, uv):
        return np.stack([uv[:, :1] * P[2] - P[0], uv[:, 1:] * P[2] - P[1]], axis=1)

    A = np.concatenate([rows(P1.astype(np.float64), uv1.astype(np.float64)),
                        rows(P2.astype(np.float64), uv2.astype(np.float64))], axis=1)
    A = A / np.linalg.norm(A, axis=-1, keepdims=True)
    M, b = A[..., :3], A[..., 3]
    return -np.einsum("nij,nj->ni", np.linalg.inv(np.einsum("nri,nrj->nij", M, M)),
                      np.einsum("nri,nr->ni", M, b))


# ---------------------------------------------------------------- map state

def test_map_round_trip(built):
    maps, _, _, _ = built
    back = to_numpy(from_jax_numpy(maps[-1]))
    assert back.kf_desc.dtype == np.uint32 and back.pt_desc.dtype == np.uint32
    assert_map_equal(from_jax_numpy(maps[-1]), maps[-1], tol=dict(rtol=0, atol=0))


@pytest.mark.parametrize("covis_mode", ["row", "full"])
def test_insert_keyframe_matches_reference(built, covis_mode):
    maps, slots, frames, binds = built
    th_far = JCFG.tracking.th_depth * JCFG.camera.baseline_m
    for i in (0, 3):
        ref, ref_slot = jmap.insert_keyframe(jax.tree.map(jnp.asarray, maps[i]),
                                             jax.tree.map(jnp.asarray, frames[i]),
                                             jnp.asarray(binds[i]), th_far,
                                             covis_mode=covis_mode)
        out, slot = tmap.insert_keyframe(from_jax_numpy(maps[i]), from_jax_numpy(frames[i]),
                                         torch.from_numpy(binds[i]), th_far,
                                         covis_mode=covis_mode)
        assert int(slot) == int(ref_slot) == slots[i]
        assert_map_equal(out, _np_tree(ref))


def _cases():
    return {
        "recompute_covisibility": (
            lambda mod, m, s: m._replace(covis=mod.recompute_covisibility(m))),
        "covis_update_row": lambda mod, m, s: mod.covis_update_row(m, s),
        "point_observation_counts": (
            lambda mod, m, s: m._replace(pt_visible=mod.point_observation_counts(m))),
        "cull_points": lambda mod, m, s: mod.cull_points(m, m.next_kf_id + 1),
        "cull_keyframes": lambda mod, m, s: mod.cull_keyframes(m, s),
        "reassign_point_refs_kill": lambda mod, m, s: mod.reassign_point_refs(
            m._replace(kf_valid=_kill_kf(m, 1)), True),
        "reassign_point_refs_keep": lambda mod, m, s: mod.reassign_point_refs(
            m._replace(kf_valid=_kill_kf(m, 1)), False),
        "evict_oldest_if_full": lambda mod, m, s: mod.evict_oldest_if_full(m, min_free=12),
        "refresh_windowed": lambda mod, m, s: mod.refresh_windowed(
            m, _arange_like(m, 300, 1000), _slots_like(m, [s, 0, 2, -1])),
    }


def _kill_kf(m, k):
    """``kf_valid`` with keyframe slot ``k`` retired, in the tree's own
    framework."""
    if isinstance(m.kf_valid, torch.Tensor):
        v = m.kf_valid.clone()
        v[k] = False
        return v
    return m.kf_valid.at[k].set(False)


def _arange_like(m, lo, hi):
    a = np.arange(lo, hi, dtype=np.int32)
    a[::7] = -1
    return torch.from_numpy(a) if isinstance(m.kf_valid, torch.Tensor) else jnp.asarray(a)


def _slots_like(m, slots):
    a = np.asarray([int(s) for s in slots], np.int32)
    return torch.from_numpy(a) if isinstance(m.kf_valid, torch.Tensor) else jnp.asarray(a)


@pytest.mark.parametrize("name", sorted(_cases()))
def test_map_function_matches_reference(built, name):
    maps, slots, _, _ = built
    fn = _cases()[name]
    m_ref = jax.tree.map(jnp.asarray, maps[-1])
    ref = fn(jmap, m_ref, jnp.asarray(slots[-1]))
    out = fn(tmap, from_jax_numpy(maps[-1]), torch.tensor(slots[-1]))
    assert_map_equal(out, _np_tree(ref))


def test_refresh_windowed_normal_sums_match_index_add(built):
    """``refresh_windowed`` sums the normals by segments in the observations'
    order (``block_order``, ``block_sum``: fixed on every device, where a
    float ``index_add`` adds by atomics on the card).  On the CPU that is
    ``index_add``'s order: the normals equal, bit for bit, the ``index_add``
    sums of the same observations, the code it replaced."""
    maps, slots, _, _ = built
    m = from_jax_numpy(maps[-1])
    pts, kfs = _arange_like(m, 0, 1000), _slots_like(m, [slots[-1], 0, 1, 2, 3, 4, -1])
    out = tmap.refresh_windowed(m, pts, kfs)
    P, K, PL = m.pt_capacity, m.kf_capacity, pts.shape[0]
    ok = pts >= 0
    g2l = torch.full((P,), PL, dtype=torch.int64)
    g2l[pts[ok].long()] = torch.arange(PL)[ok]
    kf = kfs.clamp(0, K - 1).long()
    binds = m.kf_obs_point[kf]
    bound = (m.kf_feat_valid[kf] & (binds >= 0) & (kfs >= 0)[:, None]
             & m.kf_valid[kf][:, None])
    safe_b = binds.clamp(0, P - 1).long()
    loc = torch.where(bound, g2l[safe_b], PL).reshape(-1)
    T = m.kf_T_cw[kf]
    view = m.pt_pos[safe_b] + torch.einsum("kji,kj->ki", T[:, :3, :3], T[:, :3, 3])[:, None]
    nrm = view / (torch.linalg.vector_norm(view, dim=-1, keepdim=True) + 1e-9)
    sums = torch.zeros((PL + 1, 3)).index_add(
        0, loc, torch.where(bound[..., None], nrm, 0.0).reshape(-1, 3))[:PL]
    n = torch.zeros((PL + 1,), dtype=torch.int32).index_add(
        0, loc, bound.reshape(-1).to(torch.int32))[:PL]
    write = ok & (n > 0)
    assert int(write.sum()) > 100 and int(n.max()) >= 3
    assert torch.equal(out.pt_normal[pts[write].long()], (sums / n.clamp(min=1)[:, None])[write])


def test_grow_map_and_alloc_match_reference(built):
    maps, _, _, _ = built
    ref = jmap.grow_map(jax.tree.map(jnp.asarray, maps[-1]), 64, 8192)
    out = tmap.grow_map(from_jax_numpy(maps[-1]), 64, 8192)
    assert_map_equal(out, _np_tree(ref))
    want = np.zeros(1024, bool)
    want[::3] = True
    ref_s = jmap._alloc_point_slots(jnp.asarray(maps[-1].pt_valid), jnp.asarray(want))
    out_s = tmap._alloc_point_slots(torch.from_numpy(np.asarray(maps[-1].pt_valid)),
                                    torch.from_numpy(want))
    np.testing.assert_array_equal(out_s.numpy(), np.asarray(ref_s))


# ------------------------------------------------- triangulation and fusion

def test_create_new_map_points_matches_reference(built):
    maps, slots, _, _ = built
    m = maps[-1]
    counts = np.asarray(jmap.point_observation_counts(jax.tree.map(jnp.asarray, m)))
    ref, ref_c = jtri.create_new_map_points(jax.tree.map(jnp.asarray, m), slots[-1], JCFG,
                                            10, False, jnp.asarray(counts))
    out, out_c = ttri.create_new_map_points(from_jax_numpy(m), torch.tensor(slots[-1]), TCFG,
                                            10, False, torch.from_numpy(counts))
    assert int(np.asarray(ref.pt_valid).sum()) > int(np.asarray(m.pt_valid).sum()) + 20
    assert_map_equal(out, _np_tree(ref), tol=TRI_TOL)
    np.testing.assert_array_equal(out_c.numpy(), np.asarray(ref_c))


def test_run_fusion_matches_reference(built):
    maps, slots, _, _ = built
    m = jax.tree.map(jnp.asarray, maps[-1])
    # triangulate first so fusion sees new points and merges (the
    # covisibility rows stay pre-triangulation, as inside mapping_stage)
    m, _ = jtri.create_new_map_points(m, slots[-1], JCFG, 10, False,
                                      jmap.point_observation_counts(m))
    ref, ref_c = jfus.run_fusion(m, slots[-1], JCFG, 10, True,
                                 jmap.point_observation_counts(m))
    pm = _to_port(m)
    out, out_c = tfus.run_fusion(pm, torch.tensor(slots[-1]), TCFG, 10, True,
                                 tmap.point_observation_counts(pm))
    assert not np.array_equal(np.asarray(ref.kf_obs_point), np.asarray(m.kf_obs_point))
    assert_map_equal(out, _np_tree(ref))
    np.testing.assert_array_equal(out_c.numpy(), np.asarray(ref_c))
