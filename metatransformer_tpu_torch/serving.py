"""Serving: a batching dispatcher over the bucketed encoder.

Port of ``metatransformer_tpu/serving.py``. One dispatcher accepts
mixed-modality requests, tokenizes them through the ``pipeline.Data2Seq``
facades (one stacked call per modality and raw shape), groups the token
sequences by padded bucket length (``pipeline.bucket_length``), pads each
group to (bucket, batch bucket), runs ``pipeline.encode_bucketed_pooled``
and scatters the pooled features back in request order. ``ServingDaemon``
wraps it in a queue and a worker thread with max-batch / max-wait
batching, backpressure and latency percentiles.

The reference bounds the set of compiled XLA programs with the two bucket
ladders. The port compiles nothing: every call runs eagerly, so the
ladders only bound the shapes the kernels see. Tokens stay on the device of
the encoder parameters, where the padded batch and its mask are built; an
answer leaves the device once a group (``[bb, D]`` pooled, or
``[bb, lb, D]`` for ``pool="none"``) and comes back as a float32 numpy
array, as the reference returns it. Under BF16 the blocks at T <= 256 run
the fused sublayer kernels, 512 and up the flash-attention kernel, and a
point request the furthest-point-sampling kernel.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from queue import Empty, Full, Queue
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metatransformer_tpu_torch import pipeline
from metatransformer_tpu_torch.core import encoder as enc


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    encoder: enc.EncoderConfig = enc.BASE
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    precision: enc.Precision = enc.BF16
    pool: str = "mean"  # "mean" over valid tokens | "none" (full seq)
    # fused=True (pooled serving only): each flush runs every (modality,
    # raw shape, batch bucket) group straight from raw input to pooled
    # features — tokenize, encode at the group's own length, unmasked
    # fp32 mean — with one readback per flush. Mixed-length bucket sharing
    # buys nothing once outputs are pooled; the bucketed path remains the
    # mode for pool="none" and the fallback below.
    fused: bool = False
    # Ceiling on distinct packed-flush compositions (the multiset of
    # (modality, raw shape, batch bucket) groups, canonical under arrival
    # order). The reference compiles one XLA program per composition; the
    # port compiles none, but keeps the ceiling because it decides the
    # route: a flush with a NEW composition past the ceiling is served by
    # the bucketed per-group path, exactly as in the reference.
    max_packed_programs: int = 16


@dataclasses.dataclass
class Request:
    modality: str
    # raw modality input for pipeline.Data2Seq (leading batch axis of 1;
    # numpy or tensor), OR encoded payload bytes
    # (JPEG/PNG/AVI/WAV/UTF-8/npy/npz) — bytes are decoded at the serving
    # edge by data/codecs.decode_payload.
    data: Any
    request_id: int = 0


def maybe_decode(request: Request, **decode_opts) -> Request:
    """Decode an encoded-bytes request into its array form (no-op for
    array requests). Runs on the CALLER's thread in ``ServingDaemon.
    submit`` — codec work parallelizes across client threads instead of
    serializing on the flush loop, and a malformed payload fails the one
    request that sent it."""
    if isinstance(request.data, (bytes, bytearray)):
        from metatransformer_tpu_torch.data import codecs

        return dataclasses.replace(
            request,
            data=codecs.decode_payload(request.modality, bytes(request.data), **decode_opts),
        )
    return request


def batch_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch {n} exceeds the largest batch bucket {buckets[-1]}")


def _flatten(data: Any) -> Tuple[str, List[Any]]:
    """(structure, leaves) of a raw payload: dicts in sorted key order, then
    lists and tuples, as ``jax.tree.flatten`` walks them."""
    if isinstance(data, dict):
        keys = sorted(data)
        parts = [_flatten(data[k]) for k in keys]
        inner = ",".join(f"{k}:{s}" for k, (s, _) in zip(keys, parts))
        return "{" + inner + "}", [leaf for _, leaves in parts for leaf in leaves]
    if isinstance(data, (list, tuple)):
        parts = [_flatten(x) for x in data]
        inner = ",".join(s for s, _ in parts)
        brackets = "[]" if isinstance(data, list) else "()"
        return brackets[0] + inner + brackets[1], [leaf for _, leaves in parts for leaf in leaves]
    return "*", [data]


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    """Inverse of :func:`_flatten` over the structure of ``like``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(like)


def _dtype_name(leaf: Any) -> str:
    """'float32' for a numpy array and a tensor alike, so both land in one
    group."""
    dtype = getattr(leaf, "dtype", None)
    if dtype is None:
        return type(leaf).__name__
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


class Dispatcher:
    """Groups requests by (length bucket, batch bucket) and serves each
    group with one padded batch. Synchronous core — ``ServingDaemon`` wraps
    it in a queue thread; the grouping/padding policy is the hard part and
    is fully tested here.

    The device is the encoder parameters': request payloads are moved
    there, nothing else is."""

    def __init__(
        self,
        tokenizers: Dict[str, Tuple["pipeline.Data2Seq", Dict[str, torch.Tensor]]],
        encoder_params: Dict[str, torch.Tensor],
        cfg: ServingConfig,
    ):
        self.tokenizers = tokenizers  # modality -> (facade, params)
        # cast once: encode then finds the tree already in the policy's dtypes
        self.encoder_params = enc.cast_params(encoder_params, cfg.precision)
        self.device = next(iter(encoder_params.values())).device
        self.cfg = cfg
        self.stats: Dict[Tuple[int, int], int] = {}
        # (modality, padded batch) -> stacked tokenizer calls, mirroring
        # ``stats`` for the encoder.
        self.tok_stats: Dict[Tuple[str, int], int] = {}
        # seconds of a packed flush from its first launch to its readback,
        # excluding host-side grouping/stacking/queueing and the stacked
        # payloads' host-to-device copies — the serve-side split of
        # end-to-end latency.
        self.dispatch_s: float = 0.0
        # canonical packed-flush compositions seen so far (the reference
        # compiles one program per member).
        self._packed_comps: set = set()
        # flushes served via the bucketed fallback because a new packed
        # composition would exceed cfg.max_packed_programs.
        self.packed_fallbacks: int = 0

    @staticmethod
    def _shape_sig(data: Any) -> Tuple:
        """(structure,) + ((shape, dtype name) per leaf): the group key of a
        payload. Reads attributes only, so a payload on the card is not
        copied to the host to key its group."""
        structure, leaves = _flatten(data)
        return (structure,) + tuple(
            (tuple(getattr(leaf, "shape", ())), _dtype_name(leaf)) for leaf in leaves
        )

    def _stack_pad(self, datas: List[Any]) -> Tuple[Any, int]:
        """Stack same-shape raw inputs on the batch axis on this device,
        padded up the batch-bucket ladder (pad rows repeat the last request
        and are sliced off): ``torch.cat`` on the device when any payload is
        a tensor, else one numpy concat and one copy."""
        n = len(datas)
        bb = batch_bucket(n, self.cfg.batch_buckets)
        flat = [_flatten(d)[1] for d in datas]

        def cat(xs):
            parts = list(xs) + [xs[-1]] * (bb - n)
            if any(isinstance(x, torch.Tensor) for x in xs):
                return torch.cat([torch.as_tensor(x).to(self.device) for x in parts], dim=0)
            host = parts[0] if len(parts) == 1 else np.concatenate(
                [np.asarray(x) for x in parts], axis=0)
            return torch.from_numpy(np.ascontiguousarray(host)).to(self.device)

        leaves = [cat(xs) for xs in zip(*flat)]
        return _unflatten(datas[0], leaves), bb

    def _tokenize_group(self, modality: str, datas: List[Any]) -> List[torch.Tensor]:
        """Tokenize same-modality, same-raw-shape requests in ONE stacked
        call — the tokenize-side twin of the encoder's bucket batching.
        The tokens stay on the device."""
        facade, params = self.tokenizers[modality]
        stacked, bb = self._stack_pad(datas)
        self.tok_stats[(modality, bb)] = self.tok_stats.get((modality, bb), 0) + 1
        toks = facade(params, stacked)
        return [toks[i] for i in range(len(datas))]

    def _packed(self, raws: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One eager pass over a whole flush: every group's raw batch in,
        every group's pooled fp32 features out, in the canonical order of
        the keys (``modality/bucket/occurrence``)."""
        ecfg, prec = self.cfg.encoder, self.cfg.precision
        out = {}
        for key, raw in raws.items():
            facade, params = self.tokenizers[key.split("/", 1)[0]]
            toks = facade._apply(params, raw)
            feats = enc.encode(self.encoder_params, toks, ecfg, precision=prec)
            # Unmasked mean is correct ONLY because same-raw-shape grouping
            # guarantees every token is valid (tokenizers emit no internal
            # padding); if a tokenizer ever pads, thread a mask like
            # encode_bucketed_pooled does.
            out[key] = feats.float().mean(dim=1)
        return out

    def _serve_fused(self, requests, by_sig) -> List[np.ndarray]:
        # Plan first (no stacking yet): canonical group keys are
        # (modality, batch-bucket, occurrence index) under a sorted
        # signature walk, so the composition depends only on the MULTISET
        # of (modality, raw-shape, bucket) groups — the same mix arriving
        # in any order is one composition.
        cap = max(self.cfg.batch_buckets)
        plan: List[Tuple[str, Tuple, int, List[int]]] = []
        occ: Dict[Tuple[str, int], int] = {}
        for sig, idxs in sorted(by_sig.items(), key=lambda kv: kv[0]):
            modality = sig[0]
            for k in range(0, len(idxs), cap):
                chunk = idxs[k : k + cap]
                bb = batch_bucket(len(chunk), self.cfg.batch_buckets)
                g = occ.get((modality, bb), 0)
                occ[(modality, bb)] = g + 1
                plan.append((f"{modality}/{bb}/{g}", sig, bb, chunk))
        comp = tuple((key, sig, bb) for key, sig, bb, _ in plan)
        if comp not in self._packed_comps:
            if len(self._packed_comps) >= self.cfg.max_packed_programs:
                # composition ceiling: serve this flush through the
                # bucketed per-group path, as the reference does.
                self.packed_fallbacks += 1
                return self._serve_bucketed(requests, by_sig)
            self._packed_comps.add(comp)

        raws: Dict[str, Any] = {}
        rows: Dict[str, List[int]] = {}
        for key, sig, bb, chunk in plan:
            modality = sig[0]
            stacked, _ = self._stack_pad([requests[i].data for i in chunk])
            self.tok_stats[(modality, bb)] = self.tok_stats.get((modality, bb), 0) + 1
            raws[key] = stacked
            rows[key] = chunk
        out: List[Optional[np.ndarray]] = [None] * len(requests)
        t0 = time.perf_counter()
        pooled = self._packed(raws)
        # one readback for the whole flush
        host = torch.cat(list(pooled.values()), dim=0).cpu().numpy()
        self.dispatch_s += time.perf_counter() - t0
        start = 0
        for key, chunk in rows.items():
            for row, i in enumerate(chunk):
                out[i] = host[start + row]
            start += pooled[key].shape[0]
        return out  # type: ignore[return-value]

    @property
    def packed_retraces(self) -> int:
        """Distinct packed-flush compositions served so far (each one XLA
        program in the reference)."""
        return len(self._packed_comps)

    def serve(self, requests: List[Request]) -> List[np.ndarray]:
        """-> per-request pooled features (cfg.pool='mean') or full
        [T_i, D] sequences, float32 numpy, in input order. Encoded-bytes
        requests are decoded here (the sync-path twin of
        ``ServingDaemon.submit``)."""
        requests = [maybe_decode(r) for r in requests]
        by_sig: Dict[Tuple, List[int]] = {}
        for i, r in enumerate(requests):
            if r.modality not in self.tokenizers:
                raise KeyError(r.modality)
            by_sig.setdefault((r.modality,) + self._shape_sig(r.data), []).append(i)
        with torch.no_grad():
            if self.cfg.fused and self.cfg.pool == "mean":
                return self._serve_fused(requests, by_sig)
            return self._serve_bucketed(requests, by_sig)

    def _serve_bucketed(self, requests, by_sig) -> List[np.ndarray]:
        """Per-group path: tokenize each (modality, raw-shape) group,
        then encode by (length bucket, batch bucket), the batch and its
        keep-mask built on the device — the fused path's fallback under
        the composition ceiling."""
        tokens: List[Optional[torch.Tensor]] = [None] * len(requests)
        cap = max(self.cfg.batch_buckets)
        for sig, idxs in by_sig.items():
            for k in range(0, len(idxs), cap):
                chunk = idxs[k : k + cap]
                group = self._tokenize_group(sig[0], [requests[i].data for i in chunk])
                for i, t in zip(chunk, group):
                    tokens[i] = t
        groups: Dict[int, List[int]] = {}
        for i, t in enumerate(tokens):
            lb = pipeline.bucket_length(t.shape[0])
            groups.setdefault(lb, []).append(i)

        out: List[Optional[np.ndarray]] = [None] * len(requests)
        d = self.cfg.encoder.dim
        for lb, idxs in sorted(groups.items()):
            bb = batch_bucket(len(idxs), self.cfg.batch_buckets)
            batch = torch.zeros(bb, lb, d, dtype=torch.float32, device=self.device)
            mask = torch.zeros(bb, lb, dtype=torch.bool, device=self.device)
            for row, i in enumerate(idxs):
                t = tokens[i]
                batch[row, : t.shape[0]] = t
                mask[row, : t.shape[0]] = True
            self.stats[(lb, bb)] = self.stats.get((lb, bb), 0) + 1
            if self.cfg.pool == "mean":
                # pooling stays on the device: the readback is [bb, D]
                pooled = pipeline.encode_bucketed_pooled(
                    self.encoder_params, batch, mask, self.cfg.encoder,
                    precision=self.cfg.precision,
                ).float().cpu().numpy()
                for row, i in enumerate(idxs):
                    out[i] = pooled[row]
                continue
            feats = pipeline.encode_bucketed(
                self.encoder_params, batch, mask, self.cfg.encoder,
                precision=self.cfg.precision,
            ).float().cpu().numpy()
            for row, i in enumerate(idxs):
                out[i] = feats[row, : tokens[i].shape[0]]
        return out  # type: ignore[return-value]

    @property
    def num_programs(self) -> int:
        """Distinct (length, batch) shapes served (each one XLA executable
        in the reference)."""
        return len(self.stats)


# ---------------------------------------------------------------------------
# Daemon: queue/worker loop around the Dispatcher
# (the reference serves via per-task demo scripts, e.g.
# ``Image/segmentation/image_demo.py:16-40``; this is the online-serving
# equivalent with max-wait/max-batch batching and latency accounting)
# ---------------------------------------------------------------------------


class QueueFullError(RuntimeError):
    """Raised (via the request Future) when the daemon queue is at
    ``max_queue`` — the load-shedding signal for upstream retry/backoff."""


class ServingDaemon:
    """Background worker: collect requests until ``max_batch`` or
    ``max_wait_s`` elapses, flush the group through ``Dispatcher.serve``,
    resolve per-request futures. Records raw-input -> output latency per
    request; an answer is a host array, so a latency includes the wait for
    the card.

    Backpressure: with ``max_queue > 0`` the queue is bounded and
    ``submit`` rejects immediately when full (the Future resolves to
    ``QueueFullError``) instead of letting latency grow without bound —
    callers see load-shedding, not a silent multi-second p99.

    The worker thread issues the CUDA work; it makes the Dispatcher's
    device its current device first, since CUDA's current device is set
    per thread."""

    def __init__(
        self,
        dispatcher: Dispatcher,
        max_batch: int = 32,
        max_wait_s: float = 0.005,
        max_queue: int = 0,
        decode_opts: Optional[Dict[str, Any]] = None,
    ):
        self.dispatcher = dispatcher
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.decode_opts = decode_opts or {}
        self._queue: "Queue[Tuple[Request, Future, float]]" = Queue(maxsize=max_queue)
        self.rejected: int = 0
        self._latencies_s: List[float] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, request: Request) -> Future:
        """Enqueue one request -> Future resolving to its features, or
        to ``QueueFullError`` if the bounded queue is full. Encoded-bytes
        payloads decode here, on the caller's thread; a malformed payload
        resolves this request's Future without touching the flush loop."""
        fut: Future = Future()
        if isinstance(request.data, (bytes, bytearray)):
            try:
                request = maybe_decode(request, **self.decode_opts)
            except Exception as exc:
                fut.set_exception(exc)
                return fut
        try:
            self._queue.put_nowait((request, fut, time.perf_counter()))
        except Full:
            with self._lock:
                self.rejected += 1
            fut.set_exception(
                QueueFullError(f"serving queue full ({self._queue.maxsize}); shed load")
            )
        return fut

    def _collect(self) -> List[Tuple[Request, Future, float]]:
        """One flush group: first item blocks, then drain until max_batch
        or the max-wait deadline."""
        try:
            first = self._queue.get(timeout=0.05)
        except Empty:
            return []
        group = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(group) < self.max_batch:
            rem = deadline - time.perf_counter()
            if rem <= 0:
                break
            try:
                group.append(self._queue.get(timeout=rem))
            except Empty:
                break
        return group

    def _run(self) -> None:
        if self.dispatcher.device.type == "cuda":
            torch.cuda.set_device(self.dispatcher.device)
        while not self._stop.is_set():
            group = self._collect()
            if not group:
                continue
            reqs = [g[0] for g in group]
            try:
                outs = self.dispatcher.serve(reqs)
            except Exception as exc:  # resolve every waiter with the error
                for _, fut, _ in group:
                    fut.set_exception(exc)
                continue
            done = time.perf_counter()
            with self._lock:
                for (_, fut, t0), out in zip(group, outs):
                    self._latencies_s.append(done - t0)
                    fut.set_result(out)

    def reset_stats(self) -> None:
        """Drop recorded latencies (e.g. after a warm-up pass whose
        requests paid one-time costs: kernel builds, allocator growth)."""
        with self._lock:
            self._latencies_s.clear()

    def latency_percentiles(self) -> Dict[str, float]:
        """-> {"p50_ms", "p99_ms", "n"} over all served requests."""
        with self._lock:
            lats = list(self._latencies_s)
        if not lats:
            return {"p50_ms": 0.0, "p99_ms": 0.0, "n": 0}
        arr = np.asarray(lats) * 1e3
        return {
            "p50_ms": float(np.percentile(arr, 50)),
            "p99_ms": float(np.percentile(arr, 99)),
            "n": len(arr),
        }

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout)
