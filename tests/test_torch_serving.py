"""The port's ``serving.py`` vs the JAX reference: the batch-bucket ladder,
the bucketed Dispatcher (grouping, padding, program counters), the packed
path (``fused=True``: canonical compositions, the ceiling and its bucketed
fallback), the ServingDaemon (concurrency, errors, backpressure, stats),
byte payloads through ``maybe_decode``, and all twelve modalities behind
one dispatcher. One case for each test of ``tests/test_serving.py``, plus
the port's own: numpy and tensor requests in one group, ``pool="none"``,
the group key.

Inputs come from seeded numpy; weights travel JAX -> numpy ->
``convert.from_numpy``. Answers are held to the JAX Dispatcher's at
atol 1e-5 (FP32, the tolerance of ``tests/test_serving.py``), and the
counters (``stats``, ``tok_stats``, ``num_programs``, ``packed_retraces``,
``packed_fallbacks``) must be equal on the same request lists.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu import pipeline as jpipe
from metatransformer_tpu import serving as jserving
from metatransformer_tpu.core import encoder as jenc
from metatransformer_tpu_torch import pipeline, serving
from metatransformer_tpu_torch.core import convert, encoder as enc

torch.set_num_threads(1)

D = 32
TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(name, kw):
    return jpipe.MODALITIES[name][1](**kw), pipeline.MODALITIES[name][1](**kw)


IMAGE = dict(img_size=32, dim=D)


def _pair(mods, seed=0, **cfg_kw):
    """A JAX and a port Dispatcher over the same weights: ``mods`` maps a
    modality to its tokenizer config kwargs (shared by both packages)."""
    keys = iter(jax.random.split(jax.random.PRNGKey(seed), len(mods) + 1))
    jtoks, toks = {}, {}
    for name, kw in mods.items():
        jcfg, cfg = _configs(name, kw)
        jf, f = jpipe.Data2Seq(name, D, config=jcfg), pipeline.Data2Seq(name, D, config=cfg)
        params = _np(jf.init(next(keys)))
        jtoks[name] = (jf, jax.tree.map(jnp.asarray, params))
        toks[name] = (f, convert.from_numpy(params, "cpu"))
    ecfg = dict(dim=D, depth=2, num_heads=2)
    enc_params = _np(jenc.init(jenc.EncoderConfig(**ecfg), next(keys)))
    jcfg = jserving.ServingConfig(encoder=jenc.EncoderConfig(**ecfg), precision=jenc.FP32,
                                  **cfg_kw)
    cfg = serving.ServingConfig(encoder=enc.EncoderConfig(**ecfg), precision=enc.FP32, **cfg_kw)
    return (jserving.Dispatcher(jtoks, jax.tree.map(jnp.asarray, enc_params), jcfg),
            serving.Dispatcher(toks, convert.from_numpy(enc_params, "cpu"), cfg))


def _image_pair(**cfg_kw):
    return _pair({"image": IMAGE}, **cfg_kw)


def _mixed_pair(**cfg_kw):
    return _pair({"image": IMAGE, "time-series": dict(dim=D)}, **cfg_kw)


def _serve_both(jdisp, disp, datas, torch_rows=()):
    """Serve [(modality, numpy raw)] through both; rows in ``torch_rows``
    reach the port as CPU tensors. -> (JAX answers, port answers)."""
    want = jdisp.serve([jserving.Request(m, jax.tree.map(jnp.asarray, x)) for m, x in datas])
    got = disp.serve([
        serving.Request(m, convert.from_numpy(x, "cpu") if isinstance(x, dict)
                        else torch.from_numpy(x) if i in torch_rows else x)
        for i, (m, x) in enumerate(datas)
    ])
    return want, got


def _held(want, got, atol=TOL):
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=0)


def _counters(jdisp, disp):
    assert disp.stats == jdisp.stats
    assert disp.tok_stats == jdisp.tok_stats
    assert disp.num_programs == jdisp.num_programs
    assert disp.packed_retraces == jdisp.packed_retraces
    assert disp.packed_fallbacks == jdisp.packed_fallbacks


def _images(rng, n):
    return [("image", rng.standard_normal((1, 32, 32, 3)).astype(np.float32)) for _ in range(n)]


def _series(rng, n, t=48, c=1):
    return [("time-series", rng.standard_normal((1, t, c)).astype(np.float32)) for _ in range(n)]


def test_batch_bucket_ladder():
    for n in range(1, 5):
        assert serving.batch_bucket(n, (1, 2, 4)) == jserving.batch_bucket(n, (1, 2, 4))
    assert serving.batch_bucket(3, (1, 2, 4)) == 4
    with pytest.raises(ValueError, match="exceeds the largest batch bucket 4"):
        serving.batch_bucket(9, (1, 2, 4))


def test_config_has_every_reference_field_with_its_default():
    want = {f.name: f.default for f in dataclasses.fields(jserving.ServingConfig)}
    got = {f.name: f.default for f in dataclasses.fields(serving.ServingConfig)}
    assert set(got) == set(want)
    for name in ("batch_buckets", "pool", "fused", "max_packed_programs"):
        assert got[name] == want[name]
    assert got["precision"] == enc.BF16 and got["encoder"] == enc.BASE


def test_dispatcher_serves_mixed_batch_in_order():
    jdisp, disp = _image_pair()
    datas = _images(np.random.default_rng(0), 3)
    want, got = _serve_both(jdisp, disp, datas)
    _held(want, got)
    assert all(o.shape == (D,) for o in got)
    want1, got1 = _serve_both(jdisp, disp, datas[:1])
    _held(want1, got1)
    np.testing.assert_allclose(got[0], got1[0], atol=TOL)
    assert np.abs(got[0] - got[1]).max() > 1e-6
    _counters(jdisp, disp)
    assert disp.num_programs == 2 and disp.stats == {(64, 4): 1, (64, 1): 1}


def test_dispatcher_pooling_ignores_padding():
    jdisp, disp = _image_pair()
    datas = _images(np.random.default_rng(1), 3)
    want, alone = _serve_both(jdisp, disp, datas[:1])
    _held(want, alone)
    want, mixed = _serve_both(jdisp, disp, datas)
    _held(want, mixed)
    np.testing.assert_allclose(alone[0], mixed[0], atol=TOL)
    _counters(jdisp, disp)


def test_dispatcher_mixed_modalities_share_programs():
    jdisp, disp = _mixed_pair()
    rng = np.random.default_rng(4)
    datas = _images(rng, 1) + _series(rng, 1) + _images(rng, 1)
    want, got = _serve_both(jdisp, disp, datas)
    _held(want, got)
    assert all(np.isfinite(o).all() for o in got)
    _counters(jdisp, disp)
    assert disp.num_programs == 1 and disp.stats[(64, 4)] == 1


def test_numpy_and_tensor_requests_share_one_group():
    """A numpy payload and a tensor payload of one shape and dtype key the
    same group: one stacked tokenizer call, answers as JAX's."""
    jdisp, disp = _image_pair()
    datas = _images(np.random.default_rng(12), 3)
    want, got = _serve_both(jdisp, disp, datas, torch_rows=(1,))
    _held(want, got)
    assert disp.tok_stats == {("image", 4): 1} == jdisp.tok_stats
    x = datas[0][1]
    assert serving.Dispatcher._shape_sig(x) == serving.Dispatcher._shape_sig(torch.from_numpy(x))
    assert serving.Dispatcher._shape_sig(x) != serving.Dispatcher._shape_sig(x.astype(np.float64))


def test_shape_sig_walks_dicts_in_sorted_key_order():
    """Signatures of tree payloads follow jax.tree.flatten's leaf order
    (sorted dict keys), normalise dtype names and stay sortable."""
    rng = np.random.default_rng(0)
    tree = {"b": rng.standard_normal((1, 3)).astype(np.float32),
            "a": rng.integers(0, 4, (1, 2)).astype(np.int32)}
    sig = serving.Dispatcher._shape_sig(tree)
    jsig = jserving.Dispatcher._shape_sig(tree)
    assert sig[1:] == jsig[1:] == (((1, 2), "int32"), ((1, 3), "float32"))
    swapped = {"a": torch.from_numpy(tree["a"]), "b": torch.from_numpy(tree["b"])}
    assert serving.Dispatcher._shape_sig(swapped) == sig
    sigs = [("image",) + serving.Dispatcher._shape_sig(x) for x in (
        tree, rng.standard_normal((1, 4)).astype(np.float32), [np.zeros(2), (np.ones(1),)])]
    assert len(sorted(sigs)) == 3  # the packed path sorts signatures


def test_daemon_concurrent_mixed_requests():
    jdisp, disp = _image_pair()
    datas = _images(np.random.default_rng(7), 8)
    want = jdisp.serve([jserving.Request(m, jnp.asarray(x)) for m, x in datas])
    daemon = serving.ServingDaemon(disp, max_batch=4, max_wait_s=0.02)
    try:
        futs = [None] * len(datas)

        def submit(i):
            futs[i] = daemon.submit(serving.Request("image", datas[i][1]))

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(datas))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        _held(want, [f.result(timeout=60) for f in futs])
        lat = daemon.latency_percentiles()
        assert lat["n"] == len(datas)
        assert 0 < lat["p50_ms"] <= lat["p99_ms"]
    finally:
        daemon.stop()


@pytest.mark.parametrize("max_queue", [0, 4])
def test_daemon_stress_more_submitters_than_cores(max_queue):
    """Twice as many submitting threads as cores, a 1 us switch interval:
    every accepted request resolves to the synchronous answer, each exactly
    once; with a bounded queue the rejections and the answers add up to
    the submissions and ``rejected`` counts every one."""
    import os
    import sys

    _, disp = _image_pair()
    datas = [x for _, x in _images(np.random.default_rng(15), 4)]
    want = disp.serve([serving.Request("image", x) for x in datas])
    n_threads, per = 2 * (os.cpu_count() or 4), 3
    results, errors, lock = {}, [], threading.Lock()
    interval = sys.getswitchinterval()
    daemon = serving.ServingDaemon(disp, max_batch=8, max_wait_s=0.002, max_queue=max_queue)
    try:
        sys.setswitchinterval(1e-6)

        def worker(t):
            futs = [(k, daemon.submit(serving.Request("image", datas[(t + k) % 4])))
                    for k in range(per)]
            for k, f in futs:
                try:
                    out = f.result(timeout=120)
                except serving.QueueFullError as exc:
                    with lock:
                        errors.append(exc)
                    continue
                with lock:
                    assert (t, k) not in results
                    results[(t, k)] = out

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        daemon.stop()
    assert not daemon._thread.is_alive()
    assert len(results) + len(errors) == n_threads * per
    assert daemon.rejected == len(errors) and (max_queue or not errors)
    assert daemon.latency_percentiles()["n"] == len(results)
    for (t, k), out in results.items():
        np.testing.assert_allclose(out, want[(t + k) % 4], atol=TOL)


def test_daemon_propagates_errors():
    _, disp = _image_pair()
    daemon = serving.ServingDaemon(disp, max_batch=2, max_wait_s=0.01)
    try:
        bad = daemon.submit(serving.Request("nope", np.zeros((1, 2))))
        with pytest.raises(KeyError):
            bad.result(timeout=60)
    finally:
        daemon.stop()
    # an error inside serve resolves every future of its flush group, and
    # the daemon serves on
    daemon = serving.ServingDaemon(disp, max_batch=3, max_wait_s=2.0)
    try:
        rng = np.random.default_rng(8)
        reqs = [serving.Request("image", x) for _, x in _images(rng, 2)]
        reqs.append(serving.Request("image", np.zeros((1, 31, 31, 3), np.float32)))
        futs = [daemon.submit(r) for r in reqs]
        for f in futs:
            with pytest.raises(RuntimeError):
                f.result(timeout=60)
        ok = daemon.submit(reqs[0])
        assert ok.result(timeout=60).shape == (D,)
    finally:
        daemon.stop()


def test_tokenizer_batching_one_call_per_group():
    jdisp, disp = _image_pair()
    datas = _images(np.random.default_rng(3), 3)
    want, got = _serve_both(jdisp, disp, datas)
    _held(want, got)
    assert disp.tok_stats == {("image", 4): 1}
    want1, alone = _serve_both(jdisp, disp, datas[1:2])
    _held(want1, alone)
    assert disp.tok_stats[("image", 1)] == 1
    np.testing.assert_allclose(got[1], alone[0], atol=TOL)
    _counters(jdisp, disp)


def _graph_raw(rng, n_nodes=6, n_edges=8):
    return {
        "node_data": rng.integers(0, 16, (1, n_nodes, 9)).astype(np.int32),
        "edge_data": rng.integers(0, 4, (1, n_edges, 3)).astype(np.int32),
        "edge_index": rng.integers(0, n_nodes, (1, n_edges, 2)).astype(np.int32),
        "node_num": np.asarray([n_nodes], np.int32),
        "edge_num": np.asarray([n_edges], np.int32),
        "lap_eigvec": rng.standard_normal((1, n_nodes, 16)).astype(np.float32),
    }


def test_tokenizer_batching_stacks_graph_dicts():
    jdisp, disp = _pair({"graph": dict(dim=D)})
    rng = np.random.default_rng(5)
    datas = [("graph", _graph_raw(rng)) for _ in range(2)]
    want, got = _serve_both(jdisp, disp, datas)
    _held(want, got)
    assert disp.tok_stats == {("graph", 2): 1}
    want1, alone = _serve_both(jdisp, disp, datas[:1])
    _held(want1, alone)
    np.testing.assert_allclose(got[0], alone[0], atol=TOL)
    _counters(jdisp, disp)


def test_fused_serving_matches_bucketed():
    jdisp, disp = _mixed_pair(fused=True)
    rng = np.random.default_rng(11)
    datas = _images(rng, 1) + _series(rng, 1) + _images(rng, 1)
    want, got = _serve_both(jdisp, disp, datas)
    _held(want, got)
    _, bucketed = _mixed_pair()
    ref = bucketed.serve([serving.Request(m, x) for m, x in datas])
    _held(ref, got)
    assert disp.tok_stats == {("image", 2): 1, ("time-series", 1): 1}
    assert disp.num_programs == 0
    _counters(jdisp, disp)


def test_daemon_reset_stats():
    _, disp = _image_pair()
    daemon = serving.ServingDaemon(disp, max_batch=2, max_wait_s=0.01)
    try:
        fut = daemon.submit(serving.Request("image", _images(np.random.default_rng(9), 1)[0][1]))
        fut.result(timeout=60)
        assert daemon.latency_percentiles()["n"] == 1
        daemon.reset_stats()
        assert daemon.latency_percentiles() == {"p50_ms": 0.0, "p99_ms": 0.0, "n": 0}
    finally:
        daemon.stop()


def _twelve():
    """The tokenizer configs and raw requests of test_serving.py's
    twelve-modality case."""
    rng = np.random.default_rng(0)
    ts = dict(c_in=7, dim=D)
    mods = {
        "image": IMAGE, "x-ray": IMAGE, "infrared": IMAGE,
        "video": dict(num_frames=4, img_size=32, dim=D),
        "time-series": ts, "imu": ts,
        "tabular": dict(vocab_sizes=(8,) * 5, dim=D),
        "hyper": dict(img_size=1, near_band=4, num_tokens=12, dim=D),
        "point": dict(embed_dim=D),
        "audio": dict(dim=D),
        "text": dict(vocab_size=64, context_length=8, width=16, depth=2, num_heads=2,
                     proj_dim=16, target_dim=D, eot_token_id=63),
        "graph": dict(dim=D),
    }
    raws = {
        "image": rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32),
        "x-ray": rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32),
        "infrared": rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32),
        "video": rng.uniform(0, 1, (1, 4, 32, 32, 3)).astype(np.float32),
        "time-series": rng.standard_normal((1, 48, 7)).astype(np.float32),
        "imu": rng.standard_normal((1, 48, 7)).astype(np.float32),
        "tabular": rng.integers(0, 8, (1, 5)).astype(np.int32),
        "hyper": rng.standard_normal((1, 12, 4)).astype(np.float32),
        "point": rng.standard_normal((1, 128, 3)).astype(np.float32) * 0.5,
        "audio": rng.standard_normal((1, 128, 128)).astype(np.float32),
        "text": np.concatenate([rng.integers(1, 62, (1, 7)), np.full((1, 1), 63)],
                               axis=1).astype(np.int32),
        "graph": _graph_raw(rng),
    }
    return mods, [(m, raws[m]) for m in mods]


@pytest.mark.parametrize("fused", [False, True])
def test_dispatcher_serves_twelve_modalities(fused):
    """All twelve Data2Seq facades behind one dispatcher and one encoder,
    bucketed and packed: answers as the JAX Dispatcher's, equal counters,
    the eight native lengths merged into at most four programs."""
    mods, datas = _twelve()
    jdisp, disp = _pair(mods, fused=fused)
    want, got = _serve_both(jdisp, disp, datas)
    _held(want, got)
    assert all(o.shape == (D,) and np.isfinite(o).all() for o in got)
    _counters(jdisp, disp)
    if fused:
        assert disp.packed_retraces == 1 and disp.num_programs == 0
    else:
        assert disp.num_programs <= 4, disp.stats


def test_pool_none_returns_each_request_at_its_length():
    jdisp, disp = _mixed_pair(pool="none")
    rng = np.random.default_rng(13)
    datas = _images(rng, 2) + _series(rng, 1, t=40)
    want, got = _serve_both(jdisp, disp, datas)
    _held(want, got)
    assert [o.shape for o in got] == [(4, D), (4, D), (40, D)]
    _counters(jdisp, disp)


def test_packed_composition_canonical_under_arrival_order():
    jdisp, disp = _mixed_pair(fused=True)
    rng = np.random.default_rng(0)
    imgs, tss = _images(rng, 2), _series(rng, 2)
    mix = [imgs[0], tss[0], imgs[1], tss[1]]
    want, got = _serve_both(jdisp, disp, mix)
    _held(want, got)
    assert disp.packed_retraces == 1
    want_r, got_r = _serve_both(jdisp, disp, mix[::-1])
    _held(want_r, got_r)
    assert disp.packed_retraces == 1, "arrival order made a new composition"
    for w, g in zip(got, got_r[::-1]):
        np.testing.assert_allclose(g, w, atol=TOL)
    _serve_both(jdisp, disp, mix[:1])
    assert disp.packed_retraces == 2
    _counters(jdisp, disp)


def test_packed_program_ceiling_falls_back_to_bucketed():
    jdisp, disp = _mixed_pair(fused=True, max_packed_programs=1)
    rng = np.random.default_rng(1)
    img, ts = _images(rng, 1), _series(rng, 1)
    _serve_both(jdisp, disp, img)
    assert disp.packed_retraces == 1 and disp.packed_fallbacks == 0
    want, got = _serve_both(jdisp, disp, ts)
    _held(want, got)
    assert disp.packed_retraces == 1 and disp.packed_fallbacks == 1
    assert disp.num_programs >= 1
    _, free = _mixed_pair(fused=True)
    _held(free.serve([serving.Request(m, x) for m, x in ts]), got)
    _serve_both(jdisp, disp, img)
    assert disp.packed_fallbacks == 1
    _counters(jdisp, disp)


def test_daemon_backpressure_rejects_when_full():
    _, disp = _image_pair()
    daemon = serving.ServingDaemon(disp, max_batch=2, max_wait_s=0.01, max_queue=2)
    gate = threading.Event()
    orig_serve = disp.serve

    def gated_serve(reqs):
        gate.wait(timeout=30)
        return orig_serve(reqs)

    disp.serve = gated_serve
    try:
        futs = [daemon.submit(serving.Request("image", x))
                for _, x in _images(np.random.default_rng(2), 6)]
        rejected = [f for f in futs if f.done() and f.exception() is not None]
        assert len(rejected) >= 2, "queue never filled"
        assert all(isinstance(f.exception(), serving.QueueFullError) for f in rejected)
        assert daemon.rejected == len(rejected)
        gate.set()
        for f in futs:
            if f not in rejected:
                assert np.isfinite(f.result(timeout=60)).all()
    finally:
        gate.set()
        daemon.stop()


def test_byte_payloads_decode_at_the_serving_edge():
    """npy and npz bytes decode in ``serve`` (and in ``submit``, on the
    caller's thread) to the same answers as their arrays; a malformed
    payload fails only its own future."""
    from metatransformer_tpu_torch.data import codecs

    mods = {"time-series": dict(dim=D), "graph": dict(dim=D)}
    jdisp, disp = _pair(mods)
    rng = np.random.default_rng(14)
    series = rng.standard_normal((48, 1)).astype(np.float32)
    graph = {k: v[0] for k, v in _graph_raw(rng).items()}
    arrays = [("time-series", series[None]), ("graph", {k: v[None] for k, v in graph.items()})]
    want, _ = _serve_both(jdisp, disp, arrays)
    payloads = [serving.Request("time-series", codecs.encode_npy(series)),
                serving.Request("graph", codecs.encode_npz(graph))]
    _held(want, disp.serve(payloads))
    daemon = serving.ServingDaemon(disp, max_batch=4, max_wait_s=0.02)
    try:
        futs = [daemon.submit(r) for r in payloads]
        bad = daemon.submit(serving.Request("time-series", b"not a payload"))
        _held(want, [f.result(timeout=60) for f in futs])
        with pytest.raises(ValueError, match="cannot sniff a container"):
            bad.result(timeout=60)
    finally:
        daemon.stop()


def test_dispatcher_takes_its_device_from_the_encoder():
    _, disp = _image_pair()
    assert disp.device == torch.device("cpu")
    stacked, bb = disp._stack_pad([np.ones((1, 2), np.float32), np.zeros((1, 2), np.float32)])
    assert bb == 2 and isinstance(stacked, torch.Tensor) and stacked.device == disp.device
    stacked, bb = disp._stack_pad([np.ones((1, 2), np.int32)] * 3)
    assert bb == 4 and stacked.dtype == torch.int32
    np.testing.assert_array_equal(stacked.numpy(), np.ones((4, 2), np.int32))
