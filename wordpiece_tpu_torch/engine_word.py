"""Word-centric Fast encoder: dedupe units on host, tokenize on the card.

Why units are independent (semantics proven against the reference worker
loop, src/fast.cpp:43-99):
 - no match can cross a spacing char: the probe window at i stops at the
   first spacing char after i (src/fast.cpp:54-60);
 - punctuation probes a window of 1, so a cut after punctuation is safe;
 - a CJK char's window extends into the following non-spacing run, so a
   CJK char is glued to that run (and only cut before it is safe);
 - the walk enters a later unit only at that unit's first position, which
   is always a word-prefix position (text start, a spacing char itself,
   or preceded by one);
 - the UNK rollback never crosses a word-prefix position.

Hence tokenization is a pure function of unit content, units can be
deduped (Zipf: typically 5-20x fewer unique units than occurrences), and
the per-occurrence id stream is the concatenation of per-unit streams.

Pipeline:
 host C++ : segment + dedupe + fill unique units into width buckets
 device   : one CUDA match+commit launch for all buckets, then the
            compaction kernel's vector of the emitted ids
            (ops/word_kernel_cuda.py)
 host C++ : expand unique token lists back to the occurrence stream
 fallback : units longer than the widest bucket (rare) use the native
            scalar encoder — identical semantics, host-verified in tests.

One code path runs on both devices: on device="cpu" the wrappers run the
kernel's plain PyTorch version, so the CPU tests exercise the same
dispatch, compact decode and overflow logic that the card runs.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .core import unicode as uni
from .core.length_tables import build_length_tables, load_length_tables
from .core.vocab import Vocabulary
from .ops import word_kernel_cuda as wk
from .runtime import loader

# Bucket widths (codepoints per unit).  Finer buckets mean short units
# skip the candidate rows of long token lengths entirely.
STRIDES = (8, 16, 32, 128)
WIDTHS = tuple(s - 1 for s in STRIDES)


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent
    (an entry point never carries on silently on the CPU)."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU"
            )
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return d


def _narrow(mat: np.ndarray) -> np.ndarray:
    """int32 unit matrix -> the narrowest dtype holding its codepoints
    (uint8 for Latin-1, uint16 for the BMP), so H2D ships 1-2 bytes per
    codepoint."""
    mx = int(mat.max()) if mat.size else 0
    if mx <= 0xFF:
        return mat.astype(np.uint8)
    if mx <= 0xFFFF:
        return mat.astype(np.uint16)
    return np.ascontiguousarray(mat, dtype=np.int32)


def compact_cap(n_units: int) -> int:
    """Compact-output capacity for a dispatch of n_units units: ~1.2
    ids/unit is typical; 2x + slack covers heavy-subword corpora, with a
    full-emit fallback beyond."""
    return 1 << max(13, (2 * n_units + 1024 - 1).bit_length())


def _fetch_under_deadline(fn, timeout_s: float):
    """Run fn() — a BLOCKING device fetch — on a fresh daemon thread and
    wait up to timeout_s.  Returns (True, value) on success, (False,
    None) on deadline; an exception raised by fn propagates to the
    caller.  On timeout the worker stays blocked on the stuck fetch — it
    is a daemon thread, so it can never block interpreter exit, and each
    fetch gets a fresh thread so later fetches never queue behind it."""
    box: dict = {}
    done = threading.Event()

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:
            box["exc"] = e
        finally:
            done.set()

    t = threading.Thread(target=run, daemon=True, name="wp-device-fetch")
    t.start()
    if not done.wait(timeout_s):
        return False, None
    if "exc" in box:
        raise box["exc"]
    return True, box["value"]


# Failures that device_role="auto" rescues on the host, and only on a CPU
# encoder: a fetch that misses its deadline.  On a CUDA device the miss
# propagates, so work the caller put on the card never moves to the CPU.
# A CUDA error poisons the context, so rescuing onto the host would only
# hide it: it propagates, as host-side bugs do.
_DEVICE_ERRORS = (TimeoutError,)


class _TokenStore:
    """Growable (flat ids, offsets) holding every unique unit's token list
    for one encode session; uid u's ids live at flat[offs[u]:offs[u+1]].
    Keeps >= 2 readable slots past the used region (wp_expand over-reads
    2 ids per occurrence by design)."""

    def __init__(self):
        self.flat = np.zeros(1 << 15, dtype=np.int32)
        self.n = 0
        self.offs = np.zeros((1 << 14) + 1, dtype=np.int64)
        self.nu = 0

    def append(self, run_flat: np.ndarray, counts: np.ndarray) -> None:
        """Append k new units' runs (run_flat in uid order; counts int64[k])."""
        k = counts.shape[0]
        m = run_flat.shape[0]
        if self.n + m + 2 > self.flat.shape[0]:
            cap = max(self.n + m + 2, 2 * self.flat.shape[0])
            nf = np.zeros(cap, dtype=np.int32)
            nf[: self.n] = self.flat[: self.n]
            self.flat = nf
        if self.nu + k + 1 > self.offs.shape[0]:
            cap = max(self.nu + k + 1, 2 * self.offs.shape[0])
            no = np.zeros(cap, dtype=np.int64)
            no[: self.nu + 1] = self.offs[: self.nu + 1]
            self.offs = no
        self.flat[self.n : self.n + m] = run_flat
        seg = self.offs[self.nu + 1 : self.nu + 1 + k]
        np.cumsum(counts, out=seg)
        seg += self.n
        self.n += m
        self.nu += k


class WordEncoder:
    """Deduped unit encoder (the production fast path)."""

    def __init__(
        self,
        vocab: Vocabulary,
        *,
        device="cuda",
        cache: bool = False,
        device_role: str = "primary",
    ):
        """device: "cuda" (default; raises if no GPU is present) or "cpu".
        On a CUDA device the kernel is built here, so a build failure
        raises before any encode; H2D, kernel and D2H of every chunk run
        on one stream owned by the encoder.

        cache=True keeps the dedupe session and per-unit token lists
        ALIVE ACROSS encode calls (a vocabulary-lifetime unit cache):
        repeated vocabulary — log streams, epochs over a corpus — skips
        the device work entirely on later calls.  Memory grows with the
        number of distinct units ever seen (~bytes of unique text); call
        reset_cache() to drop it.

        Every emitted token's string is checked against the vocabulary
        on the host (cheap: only unique units), and a mismatching unit is
        re-encoded with the native scalar oracle.  This catches any hash
        collision that surfaces as an emitted token; the residual risk (a
        collision at a never-emitted position perturbing only UNK
        placement) stays at ~2^-64 per probe.  Repaired units are counted
        in self.verify_repairs.

        device_role:
          - "primary" (default): a device fetch blocks until the result
            arrives, however long that takes.
          - "auto" (chosen by make_encoder for the production path):
            identical pipeline and identical ids, but the blocking fetch
            runs on a daemon worker thread under a deadline
            (DEVICE_FIRST_FETCH_TIMEOUT_S for the encoder's first fetch,
            DEVICE_FETCH_TIMEOUT_S after).  On a CUDA device a fetch that
            misses its deadline raises TimeoutError: the encode fails
            rather than carry on on the CPU.  On device="cpu" it is
            RESCUED by encoding that chunk's units with the native host
            oracle; after DEVICE_DEAD_AFTER consecutive rescues the
            plain path is latched dead and later chunks skip it.  Rescues
            are counted in self.device_fallbacks; the latest cause string
            is kept in self.last_rescue_cause.  A CUDA error is never
            rescued: it poisons the context, and it propagates."""
        if not loader.available():
            # No silent switch to another engine (the JAX package falls
            # back to its fast-stream engine here).
            raise RuntimeError(
                "the fast word engine needs the native host runtime "
                "(runtime/native), which could not be built or loaded"
            )
        self.device = resolve_device(device)
        self.vocab = vocab
        self._padded_vocab = None  # lazy (packed strings for verification)
        self.tables = build_length_tables(vocab)
        self._stream = None
        if self.device.type == "cuda":
            wk.build()
            self._stream = torch.cuda.Stream(device=self.device)
        self.dtables = load_length_tables(self.tables, self.device)
        if self._stream is not None:
            # The tables were copied on the default stream.
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._scalar = loader.VocabHandle(vocab)
        self.cache = cache
        if device_role not in ("primary", "auto"):
            raise ValueError(f"unknown device_role {device_role!r}")
        self.device_role = device_role
        self.device_fallbacks = 0  # rescued (timed-out) fetches
        self.verify_repairs = 0  # units re-encoded by _verify_emit
        self.full_fetches = 0  # fetches past the compact cap (_fetch_full)
        self.last_rescue_cause: str | None = None
        self._consec_rescues = 0
        self._device_dead = False  # latched after DEVICE_DEAD_AFTER rescues
        self._device_fetch_ok = False  # first successful fetch seen
        self._cache_state = None  # (DedupeSession, _TokenStore) when cache
        self._executor = None  # lazy 1-thread pool for pipelined prepares
        self.stats = None  # optional utils.profiling.StageStats
        self._unk_id = self.dtables.unk_id

    # -- device step -------------------------------------------------------
    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _to_device(self, arr: np.ndarray, keep: list) -> torch.Tensor:
        """numpy -> device tensor; on CUDA through a pinned buffer, copied
        asynchronously on the encoder's stream.  The pinned buffer is
        appended to `keep` (held by the chunk's handle), so it is never
        reused while its chunk is in flight."""
        t = torch.from_numpy(arr)
        if self._stream is None:
            return t
        pinned = t.pin_memory()
        keep.append(pinned)
        return pinned.to(self.device, non_blocking=True)

    def _dispatch_buckets(self, mats: list[np.ndarray]):
        """Start the device work for all non-empty buckets (asynchronous
        on CUDA); returns an opaque handle for _fetch_buckets.  Runs on
        the pipeline's worker thread: everything is enqueued on the
        encoder's own stream, and an event marks the chunk's D2H."""
        nonempty = [b for b, m in enumerate(mats) if m.shape[0]]
        if not nonempty:
            return ("sync", [None] * len(mats))
        shapes = [mats[b].shape for b in nonempty]
        cap = compact_cap(sum(u for u, _ in shapes))
        keep: list = []
        with self._on_stream():
            fused, emits = self._device_step([mats[b] for b in nonempty], cap, keep)
            event = None
            if self._stream is not None:
                host = torch.empty(fused.shape, dtype=fused.dtype, pin_memory=True)
                host.copy_(fused, non_blocking=True)  # ONE D2H transfer
                event = torch.cuda.Event()
                event.record(self._stream)
            else:
                host = fused
        return ("async", host, event, emits, nonempty, shapes, len(mats), cap, keep)

    def _device_step(self, mats: list[np.ndarray], cap: int, keep: list):
        """The device work of one dispatch, enqueued on the encoder's
        stream: the non-empty buckets' unit matrices -> (the compact
        vector over their units, their emit matrices on the device).  The
        sharded encoders (parallel/word_sharding.py) replace it; every
        collective of their step is issued here, on the one thread that
        prepares chunks (the pipeline's worker, or the caller's for a
        one-chunk encode), so the ranks issue them in chunk order."""
        cps = [self._to_device(_narrow(m), keep) for m in mats]
        return wk.word_match_commit_compact(cps, self.dtables, cap=cap)

    def _fetch_buckets(self, handle):
        if handle[0] == "sync":
            return handle[1]
        _, host, event, emits, nonempty, shapes, n_mats, cap, _keep = handle
        with self._stage("device_wait"):
            if event is not None:
                event.synchronize()
        with self._stage("fetch_unpack"):
            got = wk.decode_compact(host.numpy(), shapes, cap)
            if got is None:  # >2 ids/unit on average (UNK-heavy / char vocabs)
                self.full_fetches += 1
                got = self._fetch_full(emits)
        out: list[np.ndarray | None] = [None] * n_mats
        for b, emit in zip(nonempty, got):
            out[b] = emit
        return out

    def _fetch_full(self, emits):
        """Fallback when the compact capacity overflows: copy the full emit
        matrices, which the handle keeps on the device (no second launch)."""
        with self._on_stream():
            return [e.cpu().numpy() for e in emits]

    def _verify_emit(self, mat: np.ndarray, emit: np.ndarray) -> np.ndarray:
        """Check every emitted non-UNK token's string against the vocab;
        returns `emit` (or a repaired copy) with mismatching units
        re-encoded by the scalar oracle."""
        bad = loader.verify_emit(mat, emit, self.vocab, self._unk_id)
        if bad is not None:
            return self._repair_rows(mat, emit, bad.tolist())
        if self._padded_vocab is None:
            self._padded_vocab = self.vocab.padded(width=max(self.vocab.max_len, 1))
        padded, plens = self._padded_vocab
        unk = self._unk_id
        rr, jj = np.nonzero(emit != -2)
        if rr.size == 0:
            return emit
        tid = emit[rr, jj]
        chk = tid != unk
        rr_c, jj_c, tid_c = rr[chk], jj[chk], tid[chk]
        bad_rows: set[int] = set()
        oob = (tid_c < 0) | (tid_c >= self.vocab.size)
        if oob.any():
            bad_rows.update(rr_c[oob].tolist())
            keep = ~oob
            rr_c, jj_c, tid_c = rr_c[keep], jj_c[keep], tid_c[keep]
        if rr_c.size:
            lens = plens[tid_c].astype(np.int64)
            W = mat.shape[1]
            for k in range(padded.shape[1]):
                act = k < lens
                if not act.any():
                    break
                col = np.minimum(jj_c + k, W - 1)
                got = mat[rr_c, col]
                want = padded[tid_c, k]
                mism = act & ((got != want) | (jj_c + k >= W))
                if mism.any():
                    bad_rows.update(rr_c[mism].tolist())
        return self._repair_rows(mat, emit, bad_rows)

    def _repair_rows(self, mat: np.ndarray, emit: np.ndarray, rows) -> np.ndarray:
        """`emit`, or a copy with `rows` re-encoded by the scalar oracle
        (counted in verify_repairs)."""
        if not rows:
            return emit
        self.verify_repairs += len(rows)
        emit = emit.copy()
        for r in rows:
            row = mat[r]
            ids = self._scalar.encode(row[row != 32].astype(np.uint32))
            emit[r, :] = -2
            emit[r, : ids.shape[0]] = ids
        return emit

    # Pipelined chunking over a persistent dedupe session: occurrence ids
    # are GLOBAL across chunks (native session table, arena-backed), so
    # each chunk dispatches only its first-seen units to the device —
    # chunking costs no dedupe loss.  Chunk k+1's host segmentation and
    # device dispatch run on a worker thread (ctypes releases the GIL)
    # while the main thread fetches/stitches/expands chunk k; device work
    # and D2H copies of in-window chunks proceed asynchronously throughout.
    PIPELINE_CHUNK = 3_000_000
    # Small first chunk: the opening device batch (the corpus's unique-set
    # bulk) dispatches earlier, so its fetch returns while the worker is
    # still segmenting the body.
    PIPELINE_FIRST = 1_000_000
    PIPELINE_WINDOW = 4  # max chunks in flight (bounds host memory)

    def reset_cache(self) -> None:
        """Drop the persistent unit cache (cache=True encoders)."""
        if self._cache_state is not None:
            self._cache_state[0].close()
            self._cache_state = None

    def _stage(self, name, nbytes=0):
        st = self.stats
        return st.stage(name, nbytes) if st is not None else contextlib.nullcontext()

    def _wait_worker(self, fut):
        """A chunk's prepared state from the pipeline worker.  No local of
        the caller holds it: a chunk's device buffers must be freed before
        the wait on the next chunk, whose dispatch allocates its own."""
        with self._stage("wait_worker"):
            return fut.result()

    def _count_units(self, n_new: int, n_card: int) -> None:
        """Route counters (call with stats attached): first-seen units,
        those in a bucket matrix for the card, and the rest, which the
        host encodes."""
        self.stats.count("units_new", n_new)
        self.stats.count("units_card", n_card)
        self.stats.count("units_host", n_new - n_card)

    def encode_bytes(self, data: bytes) -> np.ndarray:
        """Encode a byte corpus."""
        with self._stage("encode", len(data)):
            return self._encode_bytes(data)

    def _encode_bytes(self, data: bytes) -> np.ndarray:
        if len(data) == 0:
            return np.zeros(0, dtype=np.int32)
        if self.cache:
            # Persistent vocabulary session: the unit table and token
            # lists survive across calls, so repeated vocabulary (log
            # streams, epochs over a corpus) skips the device entirely.
            if self._cache_state is None:
                self._cache_state = (loader.DedupeSession(), _TokenStore())
            session, store = self._cache_state
            first = store.nu == 0
        else:
            session = loader.DedupeSession()
            store = _TokenStore()
            first = True
        try:
            if len(data) <= self.PIPELINE_CHUNK:
                return self._finish_chunk(
                    data, self._prepare_chunk(data, session, first), store
                )
            # Split at space-class boundaries (units never span spaces;
            # any space-class codepoint qualifies — newline- or
            # U+2581-separated corpora must pipeline too).
            from .core.unicode import find_space_cut

            with self._stage("host_split"):
                chunks = []
                begin = 0
                n = len(data)
                while begin < n:
                    step = self.PIPELINE_FIRST if begin == 0 else self.PIPELINE_CHUNK
                    end = min(n, begin + step)
                    if end < n:
                        cut = find_space_cut(data, end)
                        end = cut if cut >= 0 else n
                    chunks.append(data[begin:end])
                    begin = end
            if self._executor is None:
                from concurrent.futures import ThreadPoolExecutor

                self._executor = ThreadPoolExecutor(max_workers=1)
            from collections import deque

            outs = []
            window: deque = deque()
            try:
                for ci, chunk in enumerate(chunks):
                    window.append(
                        (
                            chunk,
                            self._executor.submit(
                                self._prepare_chunk, chunk, session, first and ci == 0
                            ),
                        )
                    )
                    if len(window) >= self.PIPELINE_WINDOW:
                        c, f = window.popleft()
                        outs.append(self._finish_chunk(c, self._wait_worker(f), store))
                while window:
                    c, f = window.popleft()
                    outs.append(self._finish_chunk(c, self._wait_worker(f), store))
            finally:
                # Drain in-flight prepares before the session dies.
                for _, f in window:
                    try:
                        f.result()
                    except Exception:
                        pass
            with self._stage("host_concat"):
                outs = [o for o in outs if o.size]
                return np.concatenate(outs) if outs else np.zeros(0, np.int32)
        finally:
            if not self.cache:
                session.close()

    def encode_codepoints(self, cps: np.ndarray) -> np.ndarray:
        """Compatibility entry (the JAX package's): cps are re-encoded to
        UTF-8 and go to encode_bytes."""
        return self.encode_bytes(uni.encode_utf8(np.asarray(cps, dtype=np.uint32)))

    # Small first-seen batches encode on the native host oracle instead of
    # paying a device round trip.  Applied only after the session's first
    # device dispatch, so single-chunk encodes (and the kernel tests)
    # always exercise the device kernel; in the pipeline this is the Zipf
    # tail.  Same value as the JAX package, so the two route alike.
    SCALAR_MAX_NEW = 16384

    # Units of <= this many codepoints are encoded by the native scalar
    # oracle even in device-dispatching chunks: a 1-2 cp unit's MaxMatch is
    # one or two host hash probes, and CJK corpora are dominated by such
    # units.
    SCALAR_SMALL_CPLEN = 2

    # device_role="auto": give up on a device fetch after this long (raise
    # on CUDA, rescue on the host oracle on CPU).  The kernel is built eagerly in
    # __init__, so no fetch ever waits on a compile and there is no
    # per-shape compile deadline to keep; the encoder's FIRST fetch keeps
    # a longer deadline all the same, because it also absorbs the CUDA
    # context's one-time start-up (module load, first allocations).
    DEVICE_FETCH_TIMEOUT_S = 30.0
    DEVICE_FIRST_FETCH_TIMEOUT_S = 120.0
    # Consecutive rescues after which the device is latched dead and
    # later chunks skip dispatch (bounded cost for a stuck device).
    DEVICE_DEAD_AFTER = 2

    # -- host orchestration ------------------------------------------------
    def _prepare_chunk(
        self, data: bytes, session: loader.DedupeSession, first: bool = True
    ):
        """Host phases + async device dispatch for one chunk.  Returns
        (occ global uids, new_start, new_len, mats, bucket_of, row_of,
        device handle, small); all but occ are None when the chunk
        introduces no new units.  handle ("scalar", flat, counts) marks
        host-encoded batches (already in uid order, no device fetch)."""
        # loader.n_threads() parts (two by default), not the linear engine's
        # wide count: a faster worker keeps one more chunk's device state
        # alive beside the caller's, which raises the device peak.
        with self._stage("host_segment_dedupe", len(data)):
            occ, nstart, nlen, ncplen = session.segment(data)
        if nstart.shape[0] == 0:
            return (occ, None, None, None, None, None, None, None)
        # The whole batch goes to the host oracle when the device is
        # latched dead (DEVICE_DEAD_AFTER consecutive rescues: don't pay
        # another timeout) or, after the session's first chunk, when the
        # batch is small (SCALAR_MAX_NEW).
        if self._device_dead or (not first and nstart.shape[0] <= self.SCALAR_MAX_NEW):
            flat, counts = self._encode_on_host(data, nstart, nlen, int(ncplen.sum()))
            if self.stats is not None:
                self._count_units(nstart.shape[0], 0)
            return (occ, nstart, nlen, None, None, None, ("scalar", flat, counts), None)
        # Split tiny units (see SCALAR_SMALL_CPLEN) off to the host
        # oracle; the device sees only the multi-char units.
        small = None
        big_idx = None
        sel = ncplen <= self.SCALAR_SMALL_CPLEN
        if sel.any():
            small_idx = np.nonzero(sel)[0]
            sflat, scounts = self._encode_on_host(
                data, nstart[small_idx], nlen[small_idx], int(ncplen[small_idx].sum())
            )
            small = (small_idx, sflat, scounts.astype(np.int64))
            big_idx = np.nonzero(~sel)[0]
        with self._stage("host_bucket_fill"):
            if big_idx is None:
                mats, bucket_of, row_of = loader.bucket_fill(
                    data, nstart, nlen, ncplen, list(WIDTHS)
                )
            else:
                mats, b_of, r_of = loader.bucket_fill(
                    data,
                    nstart[big_idx],
                    nlen[big_idx],
                    ncplen[big_idx],
                    list(WIDTHS),
                )
                # Full-length maps: -1 marks a scalar-routed (small) unit.
                bucket_of = np.full(nstart.shape[0], -1, dtype=np.int32)
                row_of = np.zeros(nstart.shape[0], dtype=np.int32)
                bucket_of[big_idx] = b_of
                row_of[big_idx] = r_of
        if self.stats is not None:
            self._count_units(nstart.shape[0], sum(m.shape[0] for m in mats))
        with self._stage("device_dispatch"):
            handle = self._dispatch_buckets(mats)
        return (occ, nstart, nlen, mats, bucket_of, row_of, handle, small)

    def _encode_on_host(self, data: bytes, nstart, nlen, cap: int):
        """The host route: the native scalar oracle encodes the units at
        data[nstart : nstart + nlen] -> (flat ids, counts per unit); `cap`
        bounds their total codepoint length."""
        with self._stage("host_scalar_units"):
            return self._scalar.encode_units(data, nstart, nlen, cap)

    def _finish_chunk(self, data: bytes, state, store: _TokenStore) -> np.ndarray:
        """Fetch device results for one chunk's NEW units, verify, stitch
        them into the session store, then expand the chunk's occurrence
        stream from the store."""
        occ, nstart, nlen, mats, bucket_of, row_of, handle, small = state
        if nstart is not None:
            if isinstance(handle, tuple) and handle[0] == "scalar":  # host batch
                _, flat, counts = handle
                with self._stage("host_stitch"):
                    store.append(flat, counts.astype(np.int64))
            else:
                self._stitch_new_units(
                    data, nstart, nlen, mats, bucket_of, row_of, handle, store,
                    small=small,
                )
        if occ.shape[0] == 0:
            return np.zeros(0, dtype=np.int32)
        with self._stage("host_expand"):
            out = loader.expand(
                occ, store.flat, store.offs[: store.nu + 1], slack=True
            )
        return out if out is not None else np.zeros(0, np.int32)

    def _stitch_new_units(
        self, data, nstart, nlen, mats, bucket_of, row_of, handle, store,
        small=None,
    ) -> None:
        """`small`: optional (small_idx, flat, counts) of units encoded by
        the host oracle (bucket_of == -1 at those uids)."""
        with self._stage("device_fetch", len(data)):
            if self.device_role == "auto":
                timeout = (
                    self.DEVICE_FETCH_TIMEOUT_S
                    if self._device_fetch_ok
                    else self.DEVICE_FIRST_FETCH_TIMEOUT_S
                )
                try:
                    ok, emits = _fetch_under_deadline(
                        lambda: self._fetch_buckets(handle), timeout
                    )
                    if not ok:
                        raise TimeoutError(
                            f"device fetch not ready within {timeout:.0f}s"
                        )
                    self._device_fetch_ok = True
                    self._consec_rescues = 0
                except _DEVICE_ERRORS as e:
                    # A stalled fetch (CUDA errors and host-side bugs are
                    # not in _DEVICE_ERRORS and propagate).  On the card
                    # it propagates too; on the CPU, rescue the chunk on
                    # the host oracle (identical ids by construction).
                    if self.device.type == "cuda":
                        raise
                    self.device_fallbacks += 1
                    self.last_rescue_cause = repr(e)
                    self._consec_rescues += 1
                    if self._consec_rescues >= self.DEVICE_DEAD_AFTER:
                        self._device_dead = True
                    if self.stats is not None:  # the card's units move to the host
                        n_card = sum(m.shape[0] for m in mats)
                        self.stats.count("units_card", -n_card)
                        self.stats.count("units_host", n_card)
                    # Byte lengths bound the codepoint total.
                    flat, counts = self._encode_on_host(data, nstart, nlen, int(nlen.sum()))
                    store.append(flat, counts.astype(np.int64))
                    return
            else:
                emits = self._fetch_buckets(handle)
        with self._stage("host_verify"):
            for b, mat in enumerate(mats):
                if mat.shape[0]:
                    emits[b] = self._verify_emit(mat, emits[b])
        with self._stage("host_stitch"):
            order_flat, counts_u = self._emits_to_uid_flat(
                data, nstart, nlen, mats, bucket_of, row_of, emits, small
            )
            store.append(order_flat, counts_u)

    def _emits_to_uid_flat(
        self, data, nstart, nlen, mats, bucket_of, row_of, emits, small=None
    ):
        """Per-bucket emit matrices -> (order_flat, counts_u): every new
        unit's token ids concatenated in uid order."""
        n_new = nstart.shape[0]
        n_buckets = len(WIDTHS)
        flats: list[np.ndarray] = []
        bucket_row_offsets: list[np.ndarray] = []  # per bucket: int64[U_b+1]
        for b, mat in enumerate(mats):
            if mat.shape[0] == 0:
                flats.append(np.zeros(0, np.int32))
                bucket_row_offsets.append(np.zeros(1, np.int64))
                continue
            emit = emits[b]
            mask = emit != -2
            counts = mask.sum(axis=1).astype(np.int64)
            offs = np.zeros(mat.shape[0] + 1, dtype=np.int64)
            np.cumsum(counts, out=offs[1:])
            flats.append(emit[mask].astype(np.int32))
            bucket_row_offsets.append(offs)

        # Overflow units (> widest bucket): native scalar fallback.
        overflow_ids: dict[int, np.ndarray] = {}
        overflow_sel = np.nonzero(bucket_of == n_buckets)[0]
        for u in overflow_sel:
            cps = loader.decode_utf8(data[nstart[u] : nstart[u] + nlen[u]])
            overflow_ids[int(u)] = self._scalar.encode(cps)

        # Stitch per-new-unit (offset, count) into one flat array in uid
        # order, then append to the session store.
        base = np.zeros(n_buckets + 1, dtype=np.int64)
        for b in range(n_buckets):
            base[b + 1] = base[b] + flats[b].shape[0]
        over_flat = (
            np.concatenate([overflow_ids[int(u)] for u in overflow_sel])
            if overflow_sel.size
            else np.zeros(0, np.int32)
        )
        small_flat = small[1] if small is not None else np.zeros(0, np.int32)
        tok_flat = np.concatenate(flats + [over_flat, small_flat])

        counts_u = np.zeros(n_new, dtype=np.int64)
        starts_u = np.zeros(n_new, dtype=np.int64)
        for b in range(n_buckets):
            sel = bucket_of == b
            if not sel.any():
                continue
            rows = row_of[sel]
            offs = bucket_row_offsets[b]
            starts_u[sel] = base[b] + offs[rows]
            counts_u[sel] = offs[rows + 1] - offs[rows]
        if overflow_sel.size:
            pos = base[n_buckets]
            for u in overflow_sel:
                c = overflow_ids[int(u)].shape[0]
                starts_u[u] = pos
                counts_u[u] = c
                pos += c
        if small is not None:
            small_idx, _, scounts = small
            soffs = np.zeros(scounts.shape[0] + 1, dtype=np.int64)
            np.cumsum(scounts, out=soffs[1:])
            sbase = base[n_buckets] + over_flat.shape[0]
            starts_u[small_idx] = sbase + soffs[:-1]
            counts_u[small_idx] = scounts

        total = int(counts_u.sum())
        order_flat = np.empty(total, dtype=np.int32)
        if total:
            # Vectorized ragged-range gather (no Python loop): a delta
            # array that is 1 inside each run and jumps at run starts.
            nz = counts_u > 0
            su = starts_u[nz]
            ln = counts_u[nz]
            first_pos = np.concatenate([[0], np.cumsum(ln)[:-1]])
            d = np.ones(total, dtype=np.int64)
            d[first_pos[0]] = su[0]
            if su.shape[0] > 1:
                d[first_pos[1:]] = su[1:] - (su[:-1] + ln[:-1]) + 1
            order_flat[:] = tok_flat[np.cumsum(d)]
        return order_flat, counts_u
