"""The port's place recognition vs the reference package: vocabulary,
keyframe database, BoW-gated matching.

The same numpy inputs, made from a seed, go through both.  Tolerances, and
why:

- the trainer and the text loader are numpy on both sides with the same
  ``np.random.default_rng(seed)``: arrays identical;
- word ids, depth-2 nodes, common-word counts and BoW matches are integers
  decided by integer Hamming distances with first-minimum ties: identical;
- BoW vectors, scores and candidate scores are float32 sums over the W
  words, summed in another order than XLA:CPU's: 1e-6 (the values are <= 1);
- ``detect_candidates`` gates float sums (``counts >= 0.8 * max``, ``score
  >= min_score``, ``acc >= 0.75 * best``): the candidates must be the same
  wherever no value lies within 1e-6 of its gate, and the fixtures are
  checked to keep every value further away than that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendlv_perception_vision_orbslam2_tpu.models import kfdb as jkfdb
from opendlv_perception_vision_orbslam2_tpu.models import vocabulary as jvoc
from opendlv_perception_vision_orbslam2_tpu.ops import matching as jmatching
from opendlv_perception_vision_orbslam2_tpu_torch.models import kfdb as tkfdb
from opendlv_perception_vision_orbslam2_tpu_torch.models import vocabulary as tvoc
from opendlv_perception_vision_orbslam2_tpu_torch.ops import matching as tmatching
from opendlv_perception_vision_orbslam2_tpu_torch.utils.convert import from_jax_numpy, to_numpy

torch.set_num_threads(2)

ARRAYS = ("node_desc", "children", "node_word", "word_weight")


def _random_descs(m, seed=0):
    return np.random.default_rng(seed).integers(0, 2**32, (m, 8), dtype=np.uint32)


def _perturb(descs, n_bits, seed=1):
    """Flip ``n_bits`` random bits in each descriptor."""
    rng = np.random.default_rng(seed)
    bits = np.unpackbits(descs.view(np.uint8).reshape(len(descs), 32), axis=1,
                         bitorder="little")
    for i in range(len(bits)):
        bits[i, rng.choice(256, n_bits, replace=False)] ^= 1
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32).reshape(len(descs), 8)


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _assert_vocab_equal(out: tvoc.Vocabulary, ref: jvoc.Vocabulary):
    got = to_numpy(out)
    for name in ARRAYS:
        a, b = getattr(got, name), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (out.levels, out.branching, out.n_words) == (ref.levels, ref.branching, ref.n_words)
    assert out.node_desc.dtype == torch.int32


# (descriptors, branching, levels, seed); the third has few descriptors for
# its tree, so leaves sit above the deepest level
TRAIN_CASES = {
    "b6_l3": (2000, 6, 3, 0),
    "b10_l4": (3000, 10, 4, 8),
    "early_leaves": (260, 10, 4, 3),
}


@pytest.fixture(scope="module", params=list(TRAIN_CASES))
def vocab_pair(request):
    m, k, levels, seed = TRAIN_CASES[request.param]
    descs = _random_descs(m, seed=seed + 20)
    ref = jvoc.train_vocabulary(descs, branching=k, levels=levels, seed=seed)
    # the port trains on the int32 view a tensor's numpy() gives
    out = tvoc.train_vocabulary(descs.view(np.int32), branching=k, levels=levels, seed=seed)
    return request.param, descs, ref, out


def test_train_vocabulary_is_identical(vocab_pair):
    name, _, ref, out = vocab_pair
    _assert_vocab_equal(out, ref)
    if name == "early_leaves":
        leaves = np.asarray(ref.node_word) >= 0
        depth1 = np.asarray(ref.children)[0]
        assert leaves[depth1[depth1 >= 0]].any() or leaves.sum() < ref.n_words


def test_train_vocabulary_uint32_input_is_identical():
    descs = _random_descs(500, seed=2)
    a = tvoc.train_vocabulary(descs, branching=5, levels=2, seed=1)
    b = tvoc.train_vocabulary(descs.view(np.int32), branching=5, levels=2, seed=1)
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)


def test_load_text_vocabulary_is_identical(tmp_path):
    """A 3-ary, 2-level DBoW2 text file with one early leaf."""
    rng = np.random.default_rng(4)
    lines = ["3 2 0 0"]
    parents = [0, 0, 0, 1, 1, 1, 2, 2]            # node 3 is a leaf at depth 1
    is_leaf = [0, 0, 1, 1, 1, 1, 1, 1]
    for parent, leaf in zip(parents, is_leaf):
        d = " ".join(str(v) for v in rng.integers(0, 256, 32))
        lines.append(f"{parent} {leaf} {d} {rng.uniform(0.1, 3.0):.6f}")
    path = tmp_path / "voc.txt"
    path.write_text("\n".join(lines) + "\n")
    ref = jvoc.load_text_vocabulary(str(path))
    out = tvoc.load_text_vocabulary(str(path))
    _assert_vocab_equal(out, ref)
    descs = _random_descs(64, seed=5)
    valid = np.ones(64, bool)
    rw, rn = jvoc.transform(ref, jnp.asarray(descs), jnp.asarray(valid))
    ow, on = tvoc.transform(out, _t(descs), _t(valid))
    np.testing.assert_array_equal(ow.numpy(), np.asarray(rw))
    np.testing.assert_array_equal(on.numpy(), np.asarray(rn))
    assert (np.asarray(rw) == 0).any()            # the early leaf is word 0 and is reached


def test_transform_is_identical(vocab_pair):
    """Word ids and depth-2 nodes, with invalid features; the queries are
    training descriptors, perturbed ones and unseen ones, so the integer
    child distances tie often."""
    _, descs, ref, out = vocab_pair
    q = np.concatenate([descs[:100], _perturb(descs[100:200], 20, seed=6),
                        _random_descs(56, seed=7)])
    valid = np.random.default_rng(8).uniform(size=len(q)) < 0.85
    rw, rn = jvoc.transform(ref, jnp.asarray(q), jnp.asarray(valid))
    ow, on = tvoc.transform(out, _t(q), _t(valid))
    assert ow.dtype == on.dtype == torch.int32
    np.testing.assert_array_equal(ow.numpy(), np.asarray(rw))
    np.testing.assert_array_equal(on.numpy(), np.asarray(rn))
    assert (ow.numpy()[~valid] == -1).all() and (ow.numpy()[valid] >= 0).all()


def test_transform_takes_the_first_minimum():
    """Two children at the same distance: the lower lane wins."""
    node_desc = np.zeros((4, 8), np.uint32)
    node_desc[1, 0] = 0b0011        # both children differ from the query in 2 bits
    node_desc[2, 0] = 0b1100
    node_desc[3, 0] = 0b1111
    children = np.array([[1, 2, 3], [-1, -1, -1], [-1, -1, -1], [-1, -1, -1]], np.int32)
    node_word = np.array([-1, 0, 1, 2], np.int32)
    weight = np.ones(3, np.float32)
    ref = jvoc.Vocabulary(jnp.asarray(node_desc), jnp.asarray(children), jnp.asarray(node_word),
                          jnp.asarray(weight), 1, 3, 3)
    out = from_jax_numpy(ref._replace(**{n: np.asarray(getattr(ref, n)) for n in ARRAYS}))
    q = np.zeros((1, 8), np.uint32)
    valid = np.ones(1, bool)
    rw, _ = jvoc.transform(ref, jnp.asarray(q), jnp.asarray(valid))
    ow, _ = tvoc.transform(out, _t(q), _t(valid))
    assert int(ow[0]) == int(rw[0]) == 0


def _keyframe_sets(descs, n_kf, per_kf, seed):
    """``[n_kf, per_kf, 8]`` descriptor sets: odd keyframes are noisy
    revisits of the one before, so several database rows resemble a query."""
    sets = []
    for i in range(n_kf):
        base = descs[(i // 2) * per_kf:(i // 2 + 1) * per_kf]
        sets.append(base if i % 2 == 0 else _perturb(base, 14, seed=seed + i))
    return np.stack(sets)


def test_transform_all_and_bow_vectors(vocab_pair):
    _, descs, ref, out = vocab_pair
    per_kf = 40
    sets = _keyframe_sets(descs, 6, per_kf, seed=30)
    valids = np.random.default_rng(9).uniform(size=sets.shape[:2]) < 0.9
    rw, rn = jvoc.transform_all(ref, jnp.asarray(sets), jnp.asarray(valids))
    ow, on = tvoc.transform_all(out, _t(sets), _t(valids), kf_chunk=4)   # 4 + 2
    np.testing.assert_array_equal(ow.numpy(), np.asarray(rw))
    np.testing.assert_array_equal(on.numpy(), np.asarray(rn))
    rows_ref = np.asarray(jvoc.bow_vectors(ref, rw))
    rows = tvoc.bow_vectors(out, ow)
    np.testing.assert_allclose(rows.numpy(), rows_ref, rtol=0, atol=1e-6)
    one = tvoc.bow_vector(out, ow[2])
    np.testing.assert_allclose(one.numpy(), np.asarray(jvoc.bow_vector(ref, rw[2])),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(one.sum()), 1.0, atol=1e-5)
    score_ref = np.asarray(jvoc.bow_score(jnp.asarray(rows_ref[0]), jnp.asarray(rows_ref)))
    score = tvoc.bow_score(rows[0], rows)
    np.testing.assert_allclose(score.numpy(), score_ref, rtol=0, atol=1e-6)
    # no valid feature: an all-zero row on both sides, no division by zero
    none = np.full((per_kf,), -1, np.int32)
    assert not tvoc.bow_vector(out, _t(none)).any()
    assert not np.asarray(jvoc.bow_vector(ref, jnp.asarray(none))).any()


K_DB = 16


@pytest.fixture(scope="module")
def database():
    """A 16-slot database with 12 rows (6 places, each seen twice), a
    reference vocabulary, and the same on the port's side."""
    descs = _random_descs(4000, seed=40)
    ref_v = jvoc.train_vocabulary(descs[:2000], branching=6, levels=3, seed=0)
    out_v = tvoc.train_vocabulary(descs[:2000], branching=6, levels=3, seed=0)
    sets = _keyframe_sets(descs, 12, 150, seed=50)
    valid = np.ones(150, bool)
    ref_db = jkfdb.empty_kfdb(K_DB, ref_v.n_words)
    out_db = tkfdb.empty_kfdb(K_DB, out_v.n_words)
    snapshot = out_db
    for i, s in enumerate(sets):
        slot = i + 1 if i >= 5 else i                          # slot 5 stays empty
        w, _ = jvoc.transform(ref_v, jnp.asarray(s), jnp.asarray(valid))
        ref_db = jkfdb.add_keyframe(ref_db, slot, jvoc.bow_vector(ref_v, w))
        w, _ = tvoc.transform(out_v, _t(s), _t(valid))
        idx = slot if i % 2 else torch.tensor(slot)            # host and tensor slots
        out_db = tkfdb.add_keyframe(out_db, idx, tvoc.bow_vector(out_v, w))
    assert not snapshot.has_row.any() and not snapshot.bow.any()   # out of place
    return descs, sets, ref_v, out_v, ref_db, out_db


def _query(database, kind):
    descs, sets, ref_v, out_v, _, _ = database
    q = {"revisit": _perturb(sets[6], 10, seed=60), "unseen": descs[3000:3150],
         "first": sets[0]}[kind]
    valid = np.ones(len(q), bool)
    w, _ = jvoc.transform(ref_v, jnp.asarray(q), jnp.asarray(valid))
    ref_q = jvoc.bow_vector(ref_v, w)
    w, _ = tvoc.transform(out_v, _t(q), _t(valid))
    return ref_q, tvoc.bow_vector(out_v, w)


def test_database_rows_and_erase(database):
    *_, ref_db, out_db = database
    np.testing.assert_array_equal(out_db.has_row.numpy(), np.asarray(ref_db.has_row))
    np.testing.assert_allclose(out_db.bow.numpy(), np.asarray(ref_db.bow), rtol=0, atol=1e-6)
    ref_e = jkfdb.erase_keyframe(ref_db, 3)
    for slot in (3, torch.tensor(3)):
        out_e = tkfdb.erase_keyframe(out_db, slot)
        np.testing.assert_array_equal(out_e.has_row.numpy(), np.asarray(ref_e.has_row))
        np.testing.assert_allclose(out_e.bow.numpy(), np.asarray(ref_e.bow), rtol=0, atol=1e-6)
    assert out_db.has_row[3] and out_db.bow[3].any()               # out of place


@pytest.mark.parametrize("kind", ["revisit", "unseen", "first"])
def test_query_scores_and_common_words(database, kind):
    *_, ref_db, out_db = database
    ref_q, out_q = _query(database, kind)
    np.testing.assert_allclose(out_q.numpy(), np.asarray(ref_q), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tkfdb.query_scores(out_db, out_q).numpy(),
                               np.asarray(jkfdb.query_scores(ref_db, ref_q)), rtol=0, atol=1e-6)
    counts = tkfdb.common_word_counts(out_db, out_q)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(jkfdb.common_word_counts(ref_db, ref_q)))
    assert counts[5] == 0 and counts.max() > 0


def _tied_covisibility(seed):
    """Symmetric integer weights in {0, 1, 2} between the 13 used slots: far
    more than 10 neighbours tie, so the top-10 is decided by slot order."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 3, (K_DB, K_DB))
    c = np.triu(c, 1)
    c = (c + c.T).astype(np.int32)
    c[13:] = 0
    c[:, 13:] = 0
    return c


def _gate_margins(ref_db, ref_q, exclude, min_score, covis):
    """The least distance of a gated value from its gate, in float64 from
    the reference's scores (the ``detect_candidates`` chain)."""
    counts = np.where(exclude, 0, np.asarray(jkfdb.common_word_counts(ref_db, ref_q)))
    scores = np.asarray(jkfdb.query_scores(ref_db, ref_q)).astype(np.float64)
    has_row = np.asarray(ref_db.has_row)
    min_common = max(0.8 * counts.max(), 1.0)
    ok = (counts >= min_common) & (scores >= min_score) & ~exclude & has_row
    base = np.where(ok, scores, 0.0)
    order = np.argsort(-covis, axis=1, kind="stable")[:, :10]
    nb = np.where(np.take_along_axis(covis, order, 1) > 0, base[order], 0.0)
    acc = np.where(ok, base + nb.sum(1), -1.0)
    margins = [np.abs(counts - min_common).min(), np.abs(acc - 0.75 * acc.max()).min()]
    if min_score > 0:
        margins.append(np.abs(scores[has_row] - min_score).min())
    live = acc[acc >= 0.75 * acc.max()]
    return min(margins), int((live > 0).sum())


@pytest.mark.parametrize("kind,min_score,n_excluded", [
    ("revisit", 0.0, 0), ("revisit", 0.02, 3), ("first", 0.0, 0), ("unseen", 0.0, 2),
])
def test_detect_candidates_with_tied_covisibility(database, kind, min_score, n_excluded):
    *_, ref_db, out_db = database
    ref_q, out_q = _query(database, kind)
    covis = _tied_covisibility(70)
    exclude = np.zeros(K_DB, bool)
    exclude[[7, 0, 11][:n_excluded]] = True           # 7 holds the revisited place
    margin, n_live = _gate_margins(ref_db, ref_q, exclude, min_score, covis)
    assert margin > 1e-6, f"fixture: a value lies {margin} from its gate"
    ref_c, ref_s = jkfdb.detect_candidates(ref_db, ref_q, jnp.asarray(exclude), min_score,
                                           jnp.asarray(covis))
    out_c, out_s = tkfdb.detect_candidates(out_db, out_q, _t(exclude), min_score, _t(covis))
    np.testing.assert_array_equal(out_c.numpy(), np.asarray(ref_c))
    np.testing.assert_allclose(out_s.numpy(), np.asarray(ref_s), rtol=0, atol=1e-6)
    assert (out_c >= 0).sum() == min(n_live, 8) >= 1
    if kind == "revisit" and n_excluded == 0:
        assert 7 in out_c.tolist()[:2]                # the revisited place or its twin


def test_topk_stable_rows_match_lax_top_k():
    import jax

    from opendlv_perception_vision_orbslam2_tpu_torch.ops.indexing import topk_stable

    covis = _tied_covisibility(71)
    ref_w, ref_i = jax.lax.top_k(jnp.asarray(covis), 10)
    out_w, out_i = topk_stable(_t(covis), 10)
    np.testing.assert_array_equal(out_w.numpy(), np.asarray(ref_w))
    np.testing.assert_array_equal(out_i.numpy(), np.asarray(ref_i))


@pytest.mark.parametrize("nn_ratio,check_rotation", [(0.75, True), (0.7, True), (0.9, False)])
def test_search_by_bow_is_identical(database, nn_ratio, check_rotation):
    descs, _, ref_v, out_v, _, _ = database
    rng = np.random.default_rng(80)
    a = descs[:128]
    perm = rng.permutation(128)
    b = _perturb(a, 6, seed=81)[perm]
    b[100:] = _random_descs(28, seed=82)               # some have no partner
    valid_a = rng.uniform(size=128) < 0.9
    valid_b = rng.uniform(size=128) < 0.9
    ang_a = rng.uniform(0, 2 * np.pi, 128).astype(np.float32)
    ang_b = (ang_a + rng.normal(0, 0.05, 128)).astype(np.float32)[perm]
    ang_b[::9] += 2.0                                  # rotation outliers
    _, na = jvoc.transform(ref_v, jnp.asarray(a), jnp.asarray(valid_a))
    _, nb = jvoc.transform(ref_v, jnp.asarray(b), jnp.asarray(valid_b))
    ref_i, ref_ok = jmatching.search_by_bow(
        jnp.asarray(a), na, jnp.asarray(valid_a), jnp.asarray(ang_a),
        jnp.asarray(b), nb, jnp.asarray(valid_b), jnp.asarray(ang_b),
        nn_ratio=nn_ratio, check_rotation=check_rotation)
    _, ta = tvoc.transform(out_v, _t(a), _t(valid_a))
    _, tb = tvoc.transform(out_v, _t(b), _t(valid_b))
    out_i, out_ok = tmatching.search_by_bow(
        _t(a), ta, _t(valid_a), _t(ang_a), _t(b), tb, _t(valid_b), _t(ang_b),
        nn_ratio=nn_ratio, check_rotation=check_rotation)
    np.testing.assert_array_equal(out_ok.numpy(), np.asarray(ref_ok))
    np.testing.assert_array_equal(out_i.numpy(), np.asarray(ref_i))
    assert out_ok.sum() > 20


def test_convert_round_trip_of_vocabulary_and_database(database):
    *_, ref_v, _, ref_db, _ = database
    np_v = ref_v._replace(**{n: np.asarray(getattr(ref_v, n)) for n in ARRAYS})
    v = from_jax_numpy(np_v)
    assert isinstance(v, tvoc.Vocabulary) and v.node_desc.dtype == torch.int32
    assert (v.levels, v.branching, v.n_words) == (ref_v.levels, ref_v.branching, ref_v.n_words)
    back = to_numpy(v)
    for name in ARRAYS:
        a, b = getattr(back, name), getattr(np_v, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)
    db = from_jax_numpy(jkfdb.KeyFrameDatabase(np.asarray(ref_db.bow), np.asarray(ref_db.has_row)))
    assert isinstance(db, tkfdb.KeyFrameDatabase) and db.capacity == K_DB
    back = to_numpy(db)
    np.testing.assert_array_equal(back.bow, np.asarray(ref_db.bow))
    np.testing.assert_array_equal(back.has_row, np.asarray(ref_db.has_row))
    # the carried-over state answers a query like the reference's
    ref_q, out_q = _query(database, "revisit")
    np.testing.assert_allclose(tkfdb.query_scores(db, out_q).numpy(),
                               np.asarray(jkfdb.query_scores(ref_db, ref_q)), rtol=0, atol=1e-6)
