"""The vocabulary-file path: a DBoW2 text vocabulary of ORBvoc's shape
(``utils/synthetic.py::write_orbvoc_text``) through both packages' loaders,
place recognition on it, and the engine with a given vocabulary.

The writer's training descriptors come from the port's front end on a
512x256 drive (seed 11) that the engine drive below (seed 5) does not see.

Tolerances, and why:

- the writer is numpy from a seed: the same descriptors and seed give the
  same bytes;
- the loaders are the same numpy code on both sides: arrays identical;
- word ids, depth-2 nodes and common-word counts are integers decided by
  integer Hamming distances with first-minimum ties: identical; BoW rows and
  scores are float32 sums over the W words in another order than XLA:CPU's:
  1e-6 (the values are <= 1), and the candidates must be the same, the
  fixture checked to keep every gated value further than that from its
  gate (as in test_torch_place.py);
- the engine drive: test_torch_slam.py's per-frame bars (the same keyframe
  decisions, poses within 5 mm and 1e-3 rad) up to the frame where the
  reference package swaps the file's vocabulary for a trained one.  After
  it the two parts on purpose: the port keeps a given vocabulary (the
  reference loads ORBvoc once, src/selflocalization.cpp:335); the
  reference package's retrain at 8 keyframes replaces it at 12.  That half
  shows the reference's fault and does not lock it in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendlv_perception_vision_orbslam2_tpu.models import frontend as jfront
from opendlv_perception_vision_orbslam2_tpu.models import kfdb as jkfdb
from opendlv_perception_vision_orbslam2_tpu.models import slam as jslam
from opendlv_perception_vision_orbslam2_tpu.models import vocabulary as jvoc
from opendlv_perception_vision_orbslam2_tpu.utils import config as jconfig
from opendlv_perception_vision_orbslam2_tpu.utils import synthetic as jsyn
from opendlv_perception_vision_orbslam2_tpu_torch.models import kfdb as tkfdb
from opendlv_perception_vision_orbslam2_tpu_torch.models import mono_slam as tmono
from opendlv_perception_vision_orbslam2_tpu_torch.models import slam as tslam
from opendlv_perception_vision_orbslam2_tpu_torch.models import vocabulary as tvoc
from opendlv_perception_vision_orbslam2_tpu_torch.models.frontend import process_stereo
from opendlv_perception_vision_orbslam2_tpu_torch.optim import pnp as tpnp
from opendlv_perception_vision_orbslam2_tpu_torch.utils import config as tconfig
from opendlv_perception_vision_orbslam2_tpu_torch.utils import synthetic as tsyn
from opendlv_perception_vision_orbslam2_tpu_torch.utils.convert import from_jax_numpy
from test_torch_place import _assert_vocab_equal, _gate_margins, _perturb, _t

torch.set_num_threads(2)

CAM_CFG = dict(fx=320.0, fy=320.0, cx=256.0, cy=128.0, bf=160.0, width=512, height=256,
               fps=10.0)
ORB = dict(n_features=600, max_keypoints=1024, n_levels=4)
RELOC = dict(enable_loop_closing=False, enable_relocalization=True)
# the engine drive: 12 keyframes by frame 12 at 1.4 m a frame, where the
# reference package swaps its vocabulary
DRIVE = dict(n_frames=13, n_points=900, seed=5, step=1.4)


def _configs():
    kw = dict(max_keyframes=32, max_map_points=4096)
    jcfg = jconfig.SystemConfig(camera=jconfig.CameraConfig(**CAM_CFG),
                                orb=jconfig.OrbConfig(**ORB),
                                tracking=jconfig.TrackingConfig(max_frames=5), **kw)
    tcfg = tconfig.SystemConfig(camera=tconfig.CameraConfig(**CAM_CFG),
                                orb=tconfig.OrbConfig(**ORB),
                                tracking=tconfig.TrackingConfig(max_frames=5), **kw)
    return jcfg, tcfg


JCFG, TCFG = _configs()


@pytest.fixture(scope="module")
def train_descs():
    """Valid descriptors of both eyes' features over 6 frames of a drive the
    engine never sees, from the port's front end, ``[M, 8]`` uint32."""
    lefts, rights, _, _ = tsyn.render_stereo_sequence(TCFG, n_frames=6, n_points=900,
                                                      seed=11, step=0.5)
    out = []
    for i in range(len(lefts)):
        f = process_stereo(torch.from_numpy(lefts[i]), torch.from_numpy(rights[i]), TCFG,
                           0.1 * i).features
        out.append(f.desc.numpy()[f.valid.numpy()])
    descs = np.concatenate(out).view(np.uint32)
    assert len(descs) > 2000
    return descs


@pytest.fixture(scope="module")
def voc_files(train_descs, tmp_path_factory):
    """``{levels: (path, stats)}`` for the k = 10 files at L = 4 and 5."""
    d = tmp_path_factory.mktemp("voc")
    out = {}
    for levels in (4, 5):
        path = d / f"voc{levels}.txt"
        out[levels] = path, tsyn.write_orbvoc_text(path, train_descs, levels=levels, seed=3)
    return out


@pytest.mark.parametrize("levels", [4, 5])
def test_writer_is_deterministic_and_has_orbvoc_shape(train_descs, voc_files, tmp_path, levels):
    path, stats = voc_files[levels]
    again = tmp_path / "again.txt"
    assert tsyn.write_orbvoc_text(again, train_descs, levels=levels, seed=3) == stats
    assert again.read_bytes() == path.read_bytes()
    other = tmp_path / "other.txt"
    tsyn.write_orbvoc_text(other, train_descs, levels=levels, seed=4)
    assert other.read_bytes() != path.read_bytes()

    k = tsyn.ORBVOC_BRANCHING
    assert stats == {"nodes": sum(k ** d for d in range(1, levels + 1)), "words": k ** levels,
                     "bytes": path.stat().st_size}
    lines = path.read_text().splitlines()
    assert lines[0] == f"{k} {levels} 0 0" and len(lines) == stats["nodes"] + 1
    rows = [ln.split() for ln in lines[1:]]
    assert all(len(r) == 35 for r in rows)
    parents = np.array([int(r[0]) for r in rows])
    leaf = np.array([int(r[1]) for r in rows], bool)
    assert (np.diff(parents) >= 0).all() and (parents < np.arange(1, len(rows) + 1)).all()
    assert (np.bincount(parents) == k).all()              # every internal node: k children
    assert leaf.sum() == k ** levels and leaf[-k ** levels:].all()
    weights = np.array([float(r[34]) for r in rows])
    n = len(train_descs)
    assert (weights[~leaf] == 0).all()
    assert (weights[leaf] > 0).all() and (weights[leaf] <= np.log(n) + 1e-6).all()
    assert (weights[leaf] < np.log(n) - 1e-6).any()       # some words are reached twice or more


@pytest.mark.parametrize("levels", [4, 5])
def test_both_loaders_read_the_same_arrays(voc_files, levels):
    path, stats = voc_files[levels]
    ref = jvoc.load_text_vocabulary(str(path))
    out = tvoc.load_text_vocabulary(str(path))
    _assert_vocab_equal(out, ref)
    assert out.n_words == stats["words"] and out.levels == levels
    assert out.children.shape == (stats["nodes"] + 1, tsyn.ORBVOC_BRANCHING)
    assert (out.node_word >= 0).sum() == stats["words"]


@pytest.fixture(scope="module")
def l5(voc_files, train_descs):
    path, _ = voc_files[5]
    return jvoc.load_text_vocabulary(str(path)), tvoc.load_text_vocabulary(str(path))


def test_transform_and_bow_vector_at_l5_are_identical(l5, train_descs):
    ref, out = l5
    q = np.concatenate([train_descs[:200], _perturb(train_descs[200:400], 12, seed=1),
                        np.random.default_rng(2).integers(0, 2**32, (56, 8), dtype=np.uint32)])
    valid = np.random.default_rng(3).uniform(size=len(q)) < 0.9
    rw, rn = jvoc.transform(ref, jnp.asarray(q), jnp.asarray(valid))
    ow, on = tvoc.transform(out, _t(q), _t(valid))
    np.testing.assert_array_equal(ow.numpy(), np.asarray(rw))
    np.testing.assert_array_equal(on.numpy(), np.asarray(rn))
    # the depth-2 node table sits at ORBvoc's gating level: 100 nodes
    assert set(on.numpy()[valid]) <= set(range(11, 111))
    rv, ov = jvoc.bow_vector(ref, rw), tvoc.bow_vector(out, ow)
    assert ov.shape == (10 ** 5,)
    np.testing.assert_allclose(ov.numpy(), np.asarray(rv), rtol=0, atol=1e-6)
    assert int((ov > 0).sum()) > 100


def test_detect_candidates_at_l5_are_identical(l5, train_descs):
    """A 12-slot database of 10 rows (5 places seen twice, slot 4 empty) and a
    revisit of place 3 (slots 7 and 8); the query's covisible group, place 4
    (slots 9 and 10), is excluded."""
    ref_v, out_v = l5
    per_kf, K = 120, 12
    db_ref, db_out = jkfdb.empty_kfdb(K, ref_v.n_words), tkfdb.empty_kfdb(K, out_v.n_words)
    valid = np.ones(per_kf, bool)
    for i in range(10):
        base = train_descs[(i // 2) * per_kf:(i // 2 + 1) * per_kf]
        s = base if i % 2 == 0 else _perturb(base, 8, seed=10 + i)
        slot = i + 1 if i >= 4 else i
        w, _ = jvoc.transform(ref_v, jnp.asarray(s), jnp.asarray(valid))
        db_ref = jkfdb.add_keyframe(db_ref, slot, jvoc.bow_vector(ref_v, w))
        w, _ = tvoc.transform(out_v, _t(s), _t(valid))
        db_out = tkfdb.add_keyframe(db_out, slot, tvoc.bow_vector(out_v, w))
    np.testing.assert_allclose(db_out.bow.numpy(), np.asarray(db_ref.bow), rtol=0, atol=1e-6)
    q = _perturb(train_descs[3 * per_kf:4 * per_kf], 8, seed=30)
    w, _ = jvoc.transform(ref_v, jnp.asarray(q), jnp.asarray(valid))
    q_ref = jvoc.bow_vector(ref_v, w)
    w, _ = tvoc.transform(out_v, _t(q), _t(valid))
    q_out = tvoc.bow_vector(out_v, w)
    covis = np.zeros((K, K), np.int32)
    for a, b, wgt in ((0, 1, 30), (2, 3, 20), (5, 6, 25), (7, 8, 40), (9, 10, 15), (8, 9, 5),
                      (1, 2, 3)):
        covis[a, b] = covis[b, a] = wgt
    exclude = np.zeros(K, bool)
    exclude[[9, 10]] = True
    np.testing.assert_array_equal(tkfdb.common_word_counts(db_out, q_out).numpy(),
                                  np.asarray(jkfdb.common_word_counts(db_ref, q_ref)))
    for min_score in (0.0, 0.01):
        margin, _ = _gate_margins(db_ref, q_ref, exclude, min_score, covis)
        assert margin > 1e-6, f"fixture: a value lies {margin} from its gate"
        ref_c, ref_s = jkfdb.detect_candidates(db_ref, q_ref, jnp.asarray(exclude), min_score,
                                               jnp.asarray(covis))
        out_c, out_s = tkfdb.detect_candidates(db_out, q_out, torch.from_numpy(exclude),
                                               min_score, torch.from_numpy(covis))
        np.testing.assert_array_equal(out_c.numpy(), np.asarray(ref_c))
        np.testing.assert_allclose(out_s.numpy(), np.asarray(ref_s), rtol=0, atol=1e-6)
        assert int(out_c[0]) in (7, 8)                     # place 3's two rows


# ---- the engine with a given vocabulary ------------------------------------------


@pytest.mark.parametrize("engine", ["stereo", "mono"])
def test_given_vocabulary_is_never_retrained(l5, engine):
    """At 8 keyframes the online lifecycle starts a retrain and swaps it in at
    12 (test_torch_reloc.py); with a given vocabulary neither happens, in
    ``StereoSlam`` and in ``MonocularSlam``, which inherits the rule."""
    _, vocab = l5
    cls = tslam.StereoSlam if engine == "stereo" else tmono.MonocularSlam
    slam = cls(TCFG, vocab=vocab, device="cpu")
    assert slam.vocab_given
    slam.db = tkfdb.empty_kfdb(slam.map.kf_capacity, vocab.n_words)
    for n in (8, 12, 32, 128):
        slam.n_keyframes = n
        slam._maybe_refresh_vocab()
        assert slam._vocab_thread is None and slam._next_vocab_refresh == slam.VOCAB_REFRESH_AT
    assert slam.vocab.node_desc is vocab.node_desc and slam.db.bow.shape[1] == 10 ** 5
    assert not cls(TCFG, device="cpu").vocab_given


def _reference_sets(valid, generator=None, n_hypotheses=tpnp.N_HYPOTHESES):
    """The sets the reference draws for this mask: PRNGKey(0) each frame."""
    w = jnp.asarray(valid.numpy()).astype(jnp.float32)
    idx = jax.random.categorical(jax.random.PRNGKey(0), jnp.log(w + 1e-9),
                                 shape=(n_hypotheses, tpnp.SET_SIZE))
    return torch.from_numpy(np.array(idx)).to(torch.int64)


def _swaps(slam, sink):
    """Record the keyframe count at each ``_adopt_vocab`` of ``slam``."""
    inner = slam._adopt_vocab

    def noted(vocab):
        sink.append(slam.n_keyframes)
        return inner(vocab)
    slam._adopt_vocab = noted


@pytest.fixture(scope="module")
def engine_drive(voc_files):
    """Both packages' ``StereoSlam`` (relocalization on, loop closing off) with
    the L = 5 file, fed the reference's front-end frames of ``DRIVE``
    through ``_step`` in the synchronous schedule, the reference's RANSAC
    sets on the port's side."""
    path, _ = voc_files[5]
    lefts, rights, _, _ = jsyn.render_stereo_sequence(JCFG, **DRIVE)
    frames = [jfront.process_stereo(jnp.asarray(lefts[i]), jnp.asarray(rights[i]), JCFG,
                                    i * 0.1) for i in range(len(lefts))]
    ref = jslam.StereoSlam(JCFG, vocab=jvoc.load_text_vocabulary(str(path)), **RELOC)
    ref.force_sync_decisions = True
    ref._pose_solver = None       # the single-device pose solve, which the port implements
    out = tslam.StereoSlam(TCFG, vocab=tvoc.load_text_vocabulary(str(path)), device="cpu",
                           **RELOC)
    out.force_sync_decisions = True
    file_vocab = out.vocab
    ref_swaps, out_swaps, per_frame = [], [], []
    _swaps(ref, ref_swaps)
    _swaps(out, out_swaps)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpnp, "sample_sets", _reference_sets)
        for cur in frames:
            T_ref = np.asarray(ref._step(cur))
            T = out._step(from_jax_numpy(jax.tree.map(np.asarray, cur))).numpy()
            per_frame.append((T_ref, T, ref.n_keyframes, out.n_keyframes, len(ref_swaps),
                              out.lost or ref.lost))
        ref.finish()
        out.finish()
    return ref, out, file_vocab, per_frame, ref_swaps, out_swaps


def test_engine_matches_reference_up_to_its_swap(engine_drive):
    ref, out, _, per_frame, ref_swaps, _ = engine_drive
    assert ref_swaps == [12], "the reference package swaps its vocabulary once, at 12"
    swap_frame = next(i for i, f in enumerate(per_frame) if f[4])
    assert swap_frame >= 10
    for i, (T_ref, T, n_ref, n_out, _, lost) in enumerate(per_frame[:swap_frame + 1]):
        assert n_out == n_ref and not lost, f"frame {i}"
        assert np.linalg.norm(T[:3, 3] - T_ref[:3, 3]) < 5e-3, f"frame {i}"
        cos = np.clip((np.trace(T_ref[:3, :3].T @ T[:3, :3]) - 1) / 2, -1, 1)
        assert np.arccos(cos) < 1e-3, f"frame {i}"


def test_engine_keeps_the_file_after_the_reference_swap(engine_drive):
    ref, out, file_vocab, per_frame, _, out_swaps = engine_drive
    # the port: the file's tensors, a 10^5-wide database, no retrain
    assert out_swaps == [] and out._vocab_thread is None
    assert out.vocab is file_vocab and out.vocab.n_words == 10 ** 5
    assert out.db.bow.shape == (out.map.kf_capacity, 10 ** 5)
    assert out.n_keyframes >= 12
    m = out.map
    words, nodes = tvoc.transform_all(out.vocab, m.kf_desc, m.kf_feat_valid)
    live = out.db.has_row
    assert torch.equal(live, m.kf_valid)
    torch.testing.assert_close(tvoc.bow_vectors(out.vocab, words)[live], out.db.bow[live],
                               rtol=0, atol=1e-6)
    assert torch.equal(nodes[live], out.kf_nodes[live])
    # the reference package: swapped to a trained 10^4-word vocabulary (its fault)
    assert ref.vocab.n_words == 10 ** 4 and ref.db.bow.shape[1] == 10 ** 4


@pytest.mark.slow
def test_full_orbvoc_shape_through_both_loaders(train_descs, tmp_path):
    """The L = 6 file, 1,111,110 nodes and 10^6 words (146 MB of text)."""
    path = tmp_path / "orbvoc.txt"
    stats = tsyn.write_orbvoc_text(path, train_descs, seed=3)
    assert stats["nodes"] == 1_111_110 and stats["words"] == 10 ** 6
    out = tvoc.load_text_vocabulary(str(path))
    ref = jvoc.load_text_vocabulary(str(path))
    _assert_vocab_equal(out, ref)
