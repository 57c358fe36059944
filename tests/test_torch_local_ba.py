"""The port's local BA and mapping stage vs the reference package.

The maps are the ones ``test_torch_mapping.py`` builds through the
reference package (its ``built`` fixture); this file holds the heavier half
of the module parity tests so the two halves run on separate test workers.
Tolerances are stated in ``test_torch_mapping.py``: integer and bool fields
exactly equal; the grid local BA's poses within 5e-5 and points within 1e-3
relative (fifteen float32 48x48 solves re-linearized at slightly different
floats).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from opendlv_perception_vision_orbslam2_tpu.models import local_mapping as jlm
from opendlv_perception_vision_orbslam2_tpu.models import map_state as jmap
from opendlv_perception_vision_orbslam2_tpu.models import slam as jslam
from opendlv_perception_vision_orbslam2_tpu.optim import ba_grid as jbag
from opendlv_perception_vision_orbslam2_tpu_torch.models import local_mapping as tlm
from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as tslam
from opendlv_perception_vision_orbslam2_tpu_torch.optim import ba_grid as tbag
from opendlv_perception_vision_orbslam2_tpu_torch.utils.convert import from_jax_numpy
from test_ba import CAM as BA_CAM
from test_ba import _make_grid_problem
from test_torch_mapping import JCFG, TCFG, _np_tree, _to_port, assert_map_equal, built  # noqa: F401

torch.set_num_threads(2)

BA_TOL = dict(rtol=1e-3, atol=5e-5)


# ------------------------------------------------------------ local BA

def test_bundle_adjust_grid_matches_reference():
    prob, _, _ = _make_grid_problem()
    ref = jbag.bundle_adjust_grid(prob, **BA_CAM)
    out = tbag.bundle_adjust_grid(from_jax_numpy_grid(prob), **BA_CAM)
    np.testing.assert_allclose(out.T_opt.numpy(), np.asarray(ref.T_opt), rtol=0, atol=5e-5)
    np.testing.assert_allclose(out.pts.numpy(), np.asarray(ref.pts), rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(out.grid_inlier.numpy(), np.asarray(ref.grid_inlier))
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-3)
    # the residual/Jacobian helpers at the same poses and points
    tprob = from_jax_numpy_grid(prob)
    for tfn, jfn in ((tbag._grid_terms, jbag._grid_terms), (tbag._obs_terms, jbag._obs_terms)):
        outs = tfn(tprob.T_all, tprob.pts, tprob, **BA_CAM)
        refs = jax.jit(lambda T, p, pr: jfn(T, p, pr, **BA_CAM))(prob.T_all, prob.pts, prob)
        for a, b in zip(outs, refs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-3)


def from_jax_numpy_grid(prob):
    return tbag.GridBAProblem(*(torch.from_numpy(np.array(x)) for x in prob))


def test_local_mapping_step_matches_reference(built):
    maps, slots, _, _ = built
    m = jax.tree.map(jnp.asarray, maps[-1])
    counts = jmap.point_observation_counts(m)
    ext_ref = jlm.extract_local_ba_grid(m, slots[-1], 8, 8, 4096, 1.2)
    ext_out = tlm.extract_local_ba_grid(_to_port(m), torch.tensor(slots[-1]), 8, 8, 4096, 1.2)
    for name in ext_ref.prob._fields:
        a = getattr(ext_out.prob, name).numpy()
        b = np.asarray(getattr(ext_ref.prob, name))
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("local_kf_slots", "local_pt_slots", "window_kf_slots"):
        np.testing.assert_array_equal(getattr(ext_out, name).numpy(),
                                      np.asarray(getattr(ext_ref, name)), err_msg=name)
    ref, ref_c = jlm.local_mapping_step(m, slots[-1], JCFG, counts=counts)
    out, out_c = tlm.local_mapping_step(_to_port(m), torch.tensor(slots[-1]), TCFG,
                                        counts=torch.from_numpy(np.asarray(counts)))
    assert_map_equal(out, _np_tree(ref), tol=BA_TOL)
    np.testing.assert_array_equal(out_c.numpy(), np.asarray(ref_c))


# ------------------------------------------------------- the mapping stage

def _fields_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_mapping_stage_matches_reference_and_leaves_its_input(built):
    maps, slots, _, _ = built
    m = jax.tree.map(jnp.asarray, maps[-1])
    ref, ref_aux = jslam.mapping_stage(m, slots[-1], JCFG, True, True, True, True)
    pm = from_jax_numpy(maps[-1])
    snapshot = [x.clone() for x in pm]
    out, aux = tslam.mapping_stage(pm, torch.tensor(slots[-1]), TCFG, True, True, True, True)
    assert _fields_equal(pm, snapshot), "mapping_stage wrote into its input map"
    np.testing.assert_array_equal(aux.numpy(), np.asarray(ref_aux))
    assert_map_equal(out, _np_tree(ref), tol=BA_TOL)


def test_insert_stage_leaves_its_input(built):
    maps, _, frames, _ = built
    pm = from_jax_numpy(maps[3])
    snapshot = [x.clone() for x in pm]
    out, slot, _, occ = tslam.insert_stage(pm, from_jax_numpy(frames[3]),
                                           torch.full((1024,), -1, dtype=torch.int32), TCFG)
    assert _fields_equal(pm, snapshot), "insert_stage wrote into its input map"
    assert int(occ[0]) == int(np.asarray(maps[3].kf_valid).sum()) + 1
    assert not torch.equal(out.kf_obs_point, pm.kf_obs_point)


def test_cpu_mapping_stage_runs_eagerly_and_never_captures(built):
    """CPU tensors take the eager stage at every call of a key: each counts
    ``mapping.eager``, none captures or replays a CUDA graph, and the
    result is ``_mapping_stage_eager``'s."""
    import time

    from opendlv_perception_vision_orbslam2_tpu_torch.utils import trace

    maps, slots, _, _ = built
    pm, slot = from_jax_numpy(maps[-1]), torch.tensor(slots[-1])
    t0 = time.perf_counter_ns()
    runs = [tslam.mapping_stage(pm, slot, TCFG, True, True, flag, True)
            for flag in (True, True, False)]
    counts = {}
    for r in trace.records(since_ns=t0):
        if isinstance(r, trace.Count):
            counts[r.name] = counts.get(r.name, 0) + r.n
    assert counts == {"mapping.eager": 3}
    assert not tslam._GRAPHS and not tslam._SEEN
    ref, ref_aux = tslam._mapping_stage_eager(pm, slot, TCFG, True, True, True, True)
    assert _fields_equal(runs[1][0], ref) and torch.equal(runs[1][1], ref_aux)
