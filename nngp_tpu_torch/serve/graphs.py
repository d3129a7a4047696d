"""Serving buckets, replayed as CUDA graphs on the card.

The Estimator predicts a batch of encoded queries at one of a few sizes,
the buckets: the powers of two from BUCKET_MIN up to a largest bucket. A
batch is padded to its bucket with copies of its last row (the JAX
package's `Estimator._bucketed_predict` policy); a batch above the largest
bucket runs in chunks of it, and the rest through its own bucket.

On a CUDA posterior every bucket's `predict_mean_std` is captured once, at
its first use or at `Estimator.warmup`, into a `torch.cuda.CUDAGraph` over a
static input buffer and a static (2, bucket) output, all the buckets'
graphs sharing one memory pool. A later batch of that bucket is one replay:
its rows are copied in, the graph replays, its results are copied out,
all under one lock, so no other replay can overwrite the pool's scratch or
outputs in between. Before a capture the bucket's predict runs once
eagerly on the capture stream (the library build, the kernels' launch
configuration, cuBLAS's handle and workspace), then the capture records
it. A capture or a replay that fails raises: there is no eager fall-back
on the card. On the CPU the same buckets run eagerly.

A graph reads the posterior's tensors by address, so it stays valid only
as long as they keep their storage: a padded posterior's in-place extend
keeps it (`GPPosterior.extend`), while a new posterior object needs new
graphs (the Estimator drops these when it installs one). A graph also
fixes the padded posterior's live order (`gp.posterior.live_rows`, the
real rows rounded up to LIVE_STEP), which an extend advances a step at a
time: when it has moved, the next run drops every bucket, and each is
captured again, into a new pool, at its next use (`recaptures`). The
distributed tier is not served from here: its predict is collective over
the mesh.

The largest bucket is BUCKET_MAX, lowered for large train sets so that the
pool (`pool_estimate`) stays within GRAPH_POOL_SHARE of the card's memory:
the exact tier's memory rule (`gp.posterior.EXACT_MEMORY_SHARE`) leaves
20% of it free, and the pool takes at most half of that.

Launches recorded into a graph count into its own tally
(`ops._build.counting_into`), not `ops.gram_cuda.LAUNCHES` or
`ops.matmul.LAUNCHES`; each replay adds the tally to
`ops.gram_cuda.REPLAYS` (the Gram kernels) and `ops.matmul.REPLAYS` (the
3xTF32 GEMM of a precision='high' Nystrom posterior).
"""

import threading
import time

import numpy as np
import torch

from nngp_tpu_torch.ops import gram_cuda, matmul
from nngp_tpu_torch.ops._build import counting_into
from nngp_tpu_torch.utils.profiling import span

BUCKET_MIN = 64
BUCKET_MAX = 8192
GRAPH_POOL_SHARE = 0.1


def bucket_of(n: int) -> int:
    """The bucket of an n-row batch (n <= the largest bucket)."""
    return max(BUCKET_MIN, 1 << (int(n) - 1).bit_length())


def buckets_upto(max_batch: int, largest: int = BUCKET_MAX):
    """The buckets up to min(max_batch, largest), smallest first."""
    out, b = [], BUCKET_MIN
    while b <= min(int(max_batch), int(largest)):
        out.append(b)
        b *= 2
    return out


def pool_estimate(post, rows: int) -> int:
    """The bytes of the graphs' pool when the largest bucket has `rows`
    rows: per row, six vectors as long as the posterior's stored rows (a
    padded posterior's live rows are at most these)
    (the cross Gram, its mask, the triangular solve's copy, result and
    square), four more in fp64 for an fp32 posterior with an input
    prescale (its variance), eight for the NTK's pair; on the Nystrom tier
    as long as its inducing rows. An NTK posterior without a train NNGP
    Gram (column-block factor) adds one `panel_symm_matmul` panel, and its
    fp64 copy with the fp64 variance. On an NVIDIA H100 80GB HBM3 at 700 W
    (`chip_smoke.py` phase 15) the pool came out at 47.8-47.9 bytes per
    row and stored row in fp64 (N = 14,896 and 44,096) and 54.9 in fp32
    with the fp64 variance."""
    from nngp_tpu_torch.gp.posterior import needs_raw_fp64
    from nngp_tpu_torch.ops.gram import SYMM_PANEL

    fixed = 0
    if hasattr(post, "x_train"):
        width, itemsize = post.x_train.shape[0], post.x_train.element_size()
        per_row = (6 if post.get == "nngp" else 8) * width * itemsize
        wide = needs_raw_fp64(post.input_scale, post.x_train.dtype)
        if wide:
            per_row += 4 * width * 8
        if post.get == "ntk" and post.k_tt_nngp is None:
            fixed = width * SYMM_PANEL * (itemsize + (8 if wide else 0))
    else:
        per_row = 6 * post.x_m.shape[0] * 8
    return int(rows) * per_row + fixed


def largest_bucket(post) -> int:
    """BUCKET_MAX, halved until the bucket's pool estimate fits within
    GRAPH_POOL_SHARE of the card's memory (BUCKET_MAX on the CPU)."""
    b = BUCKET_MAX
    if post.device.type != "cuda":
        return b
    budget = GRAPH_POOL_SHARE * torch.cuda.get_device_properties(
        post.device).total_memory
    while b > BUCKET_MIN and pool_estimate(post, b) > budget:
        b //= 2
    return b


def _live_rows(post):
    """The live order a predict of `post` reads (`gp.posterior.live_rows`),
    None on the Nystrom tier, which has none."""
    from nngp_tpu_torch.gp.posterior import live_rows

    return None if hasattr(post, "x_m") else live_rows(post)


def _tally():
    """A graph's launch tally: zero for every kernel's key."""
    return dict.fromkeys((*gram_cuda.LAUNCHES, *matmul.LAUNCHES), 0)


def _add_replays(counts):
    """Add one replay's kernel launches to the replay counters."""
    for replays in (gram_cuda.REPLAYS, matmul.REPLAYS):
        for key in replays:
            replays[key] += counts[key]


class _Bucket:
    """One captured bucket: its graph, static input, static (2, b)
    output (mean; std) and the kernel launches the graph holds."""

    def __init__(self, graph, x, out, counts):
        self.graph, self.x, self.out, self.counts = graph, x, out, counts


class BucketGraphs:
    """The serving buckets of one posterior (exact or Nystrom tier):
    `predict(x)` runs a batch through them, replaying each bucket's CUDA
    graph on the card and running the bucket eagerly on the CPU.

    lock: held around each run, capture and each copy-in, replay and
    copy-out; the Estimator holds the same lock around an in-place extend.
    Counters: `captures`, `capture_ms` (per bucket), `recaptures` (the
    times a change of the live order dropped the captured buckets) and
    `pool_bytes()`; the kernels a replay runs go to
    `ops.gram_cuda.REPLAYS` and `ops.matmul.REPLAYS`. Spans: `graphs.run`
    a chunk (attrs rows, bucket, live_rows) around, on the card,
    `graphs.capture` (attrs bucket, live_rows), `graphs.copy_in` (the
    pageable copy and the pad fill), `graphs.replay` and `graphs.copy_out`
    (which waits for the device). live_rows: the exact posterior's
    `live_rows`, None on the Nystrom tier."""

    def __init__(self, post, lock=None):
        self.post = post
        self.device = post.device
        self.dtype = post.dtype if hasattr(post, "x_m") \
            else post.x_train.dtype
        self.width = (post.x_m if hasattr(post, "x_m")
                      else post.x_train).shape[1]
        self.largest = largest_bucket(post)
        self.lock = lock if lock is not None else threading.RLock()
        self._buckets = {}
        self._live = None            # the live order the buckets fix
        self._pool = None
        self._stream = None
        self.captures = 0
        self.capture_ms = {}
        self.recaptures = 0

    @property
    def captured(self):
        """The buckets captured so far, smallest first."""
        return sorted(self._buckets)

    def predict(self, x: np.ndarray):
        """(mean, std), 1-D numpy arrays, of the encoded rows x."""
        x = np.ascontiguousarray(x)
        if x.ndim != 2 or x.shape[1] != self.width:
            raise ValueError(f"x must be (rows, {self.width}), got "
                             f"{x.shape}")
        if x.shape[0] == 0:
            empty = np.zeros(0, dtype=np.float64)
            return empty, empty
        means, stds = [], []
        for s in range(0, x.shape[0], self.largest):
            mean, std = self._run(x[s:s + self.largest])
            means.append(mean)
            stds.append(std)
        return np.concatenate(means), np.concatenate(stds)

    def _fn(self, x):
        mean, std = self.post.predict_mean_std(x)
        return torch.stack([mean.reshape(-1), std.reshape(-1)])

    def _run(self, x):
        n = x.shape[0]
        b = bucket_of(n)
        with span("graphs.run", rows=n, bucket=b) as run, self.lock:
            live = _live_rows(self.post)
            run.set(live_rows=live)
            if self.device.type != "cuda":
                if n < b:
                    x = np.concatenate([x, np.repeat(x[-1:], b - n, axis=0)])
                out = self._fn(torch.as_tensor(x, dtype=self.dtype))
                return out[0, :n].numpy(), out[1, :n].numpy()
            if self._buckets and live != self._live:
                # an extend moved the live order the graphs fix; their
                # pool goes with them (the allocator frees a pool whose
                # graphs are all gone), and the next capture starts one
                self._buckets.clear()
                self._pool = None
                self.recaptures += 1
            bucket = self._buckets.get(b)
            if bucket is None:
                bucket = self._capture(b, live)
            with span("graphs.copy_in"):
                bucket.x[:n].copy_(torch.from_numpy(x))
                if n < b:
                    bucket.x[n:] = bucket.x[n - 1]
            with span("graphs.replay"):
                bucket.graph.replay()
            _add_replays(bucket.counts)
            with span("graphs.copy_out"):
                out = bucket.out[:, :n].cpu().numpy()
            return out[0], out[1]

    def _capture(self, b: int, live) -> _Bucket:
        """Warm bucket b up on the capture stream, then capture it at the
        live order `live`."""
        with span("graphs.capture", bucket=b, live_rows=live):
            device = self.device
            t0 = time.perf_counter()
            x = torch.ones((b, self.width), dtype=self.dtype, device=device)
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            stream = self._stream
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream), counting_into(_tally()):
                self._fn(x)
            torch.cuda.current_stream(device).wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            counts = _tally()
            with counting_into(counts), \
                    torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                     capture_error_mode="thread_local"):
                out = self._fn(x)
            torch.cuda.synchronize(device)
            bucket = self._buckets[b] = _Bucket(graph, x, out, counts)
            self._live = live
            self.captures += 1
            self.capture_ms[b] = (time.perf_counter() - t0) * 1e3
            return bucket

    def pool_bytes(self):
        """Bytes of the card's memory held in the graphs' pool (None on
        the CPU, or before a capture since the buckets were last
        dropped)."""
        if self._pool is None:
            return None
        total = 0
        for seg in torch.cuda.memory_snapshot():
            if tuple(seg.get("segment_pool_id", ())) == tuple(self._pool):
                total += int(seg["total_size"])
        return total
