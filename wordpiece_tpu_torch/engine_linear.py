"""Linear (suffix-array) encoder — the reference's second algorithm, on the
card as torch ops and three hand-written kernels (the text features, the
match over the suffix array and the greedy commit).

The reference builds S = text · sep · tok_1 · sep · … · tok_k · sep and
suffix-sorts ALL of it (src/linear.cpp:87-101), even though only the k
token START positions ever enter its who-tables (src/linear.cpp:153-160).
This design drops the tokens' other suffixes: each vocab token is ONE
sort element whose key is its own symbols, precomputed per vocabulary.

Pipeline per batch (one asynchronous run of torch ops and kernels on the
encoder's stream, one device-to-host copy of a compact vector; the
features, csrc/text_features.cu, the match, csrc/linear_match.cu, and the
commit, csrc/commit.cu, are the CUDA kernels on a card and their plain
versions on the CPU; on a card the whole program is one CUDA graph a
shape, replayed, see LinearEncoder._encode_batch):
  1. text suffixes' first-max_len symbols packed into nk int32 keys
     (dense per-VOCAB alphabet; text symbols foreign to the vocabulary
     collapse into one FOREIGN code — see correctness note below);
  2. text keys ++ precomputed token keys sorted together (nk stable
     LSD passes over np_ + nv_pad elements);
  3. LCP of adjacent elements, clamped at max_len, read off the keys;
  4. who-tables by GATHER from the sorted element ids (the token id
     space is contiguous — no scatter);
  5. four surviving-slot scans (left/right x prefix/suffix kind) — the
     closed-form reformulation of the monotone stack
     (src/linear.cpp:161-213), yielding ALL tokens matching each text
     suffix (ops/linear_match.py; on a card the kernels of
     csrc/linear_match.cu, which keep no [max_len, n] state);
  6. window-capped longest-match selection + the shared greedy commit
     (ops/commit.py), identical to the Fast engine's output.

Correctness of the two non-reference liberties, both resting on the
ultrametric property of clamped LCP (lcp(a,c) = min over the adjacent
lcps between a and c in ANY lexicographically consistent order):
 - dropping non-start token suffixes removes elements from the sorted
   order; adjacent-min telescoping over the remaining elements still
   yields the exact pairwise clamped LCPs between survivors;
 - collapsing foreign text symbols to one code can inflate LCP only
   between two TEXT suffixes (tokens contain no foreign symbol, so
   token<->suffix comparisons mismatch exactly where the true symbols
   do); the sweeps observe token<->suffix LCPs as path minima, which the
   ultrametric pins to the exact pairwise value regardless of inflated
   text<->text edges in between.

Output ids equal the Fast engine's and the native oracle's, including the
probe-window cap (see ops/linear_match.py).  On device="cpu" the same ops
run on the CPU; nothing falls back to the host oracle or another engine,
and a CUDA error propagates.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import deque

import numpy as np
import torch

from .core import unicode as uni
from .core.vocab import Vocabulary
from .engine_word import resolve_device
from .ops import commit as commit_ops
from .ops.linear_match import match_from_sa
from .ops.suffix_array import lcp_clamped, suffix_array
from .ops.text_features import compute_features
from .runtime import loader


def _widen(x: torch.Tensor) -> torch.Tensor:
    """int32 from a narrowed transfer: an int16 tensor carries uint16 bits
    (shipped as int16, so no unsigned 16-bit op is needed on the card)."""
    if x.dtype == torch.int16:
        return x.to(torch.int32) & 0xFFFF
    return x.to(torch.int32)


def _linear_batch_core(
    x_dense: torch.Tensor,  # int[np_] dense text symbols; pad = 2^bits - 1
    cps_pad: torch.Tensor,  # int[np_] raw codepoints, pad 32
    n_text: int,  # true text length
    tok_keys: torch.Tensor,  # int32[nk, nv_pad] precomputed token sort keys
    tok_len: torch.Tensor,  # int32[nv_pad] (0 on pad rows)
    tok_id: torch.Tensor,  # int32[nv_pad] (-1 on pad rows)
    tok_kind: torch.Tensor,  # int32[nv_pad]: 1 prefix, 0 suffix, -1 pad
    *,
    bits: int,
    per: int,
    nk: int,
    max_len: int,
    unk_id: int,
):
    """The whole linear batch: packed text keys ++ token keys -> nk stable
    LSD passes -> key-local clamped LCP -> who-tables by gather -> 4
    sweeps -> match -> greedy commit.  Returns (ids int32[np_], positions
    int32[np_], count int32 0-d).

    Element ids: 0..np_-1 are text suffixes (id == text position),
    np_..np_+nv_pad-1 are vocab tokens.  Ties between a token and an
    identical text suffix order text-first (stable sort by element id);
    either order is sound — the left/right sweep union covers both.

    x_dense/cps_pad may arrive narrowed (int16 holding uint16 bits); they
    are widened here, on the device."""
    sa_tables, feats = batch_match_inputs(
        x_dense, cps_pad, n_text, tok_keys, tok_len, tok_id, tok_kind,
        bits=bits, per=per, nk=nk, max_len=max_len,
    )
    best_id, best_len = match_from_sa(*sa_tables, feats.window, feats.wp, max_len=max_len)
    return commit_ops.commit_with_positions(best_id, best_len, feats, n_text, unk_id=unk_id)


def batch_match_inputs(x_dense, cps_pad, n_text: int, tok_keys, tok_len, tok_id, tok_kind, *,
                       bits: int, per: int, nk: int, max_len: int):
    """The batch program up to the match: the sort, the LCP, the
    who-tables and the text features.  Returns ((rank, lcp, who_len,
    who_id, who_kind), feats), the suffix-array arguments of
    match_from_sa and the features whose window and wp it takes."""
    x_dense = _widen(x_dense)
    keys, sa, rank = sort_elements(x_dense, tok_keys, bits=bits, per=per, nk=nk)
    lcp = neighbour_lcp(keys, sa, bits=bits, per=per, max_len=max_len)
    who = who_tables(sa, x_dense.shape[0], tok_len, tok_id, tok_kind)
    return (rank, lcp, *who), compute_features(_widen(cps_pad), n_text, max_len)


def sort_elements(x_dense: torch.Tensor, tok_keys: torch.Tensor, *, bits: int, per: int, nk: int):
    """Pack the text suffix keys, append the token keys and sort all
    elements.  Returns (keys int32[nk, nm], sa int64[nm] element ids in
    sorted order, rank int32[nm] of every element)."""
    dev = x_dense.device
    np_ = x_dense.shape[0]
    nm = np_ + tok_keys.shape[1]
    # Text suffix keys: symbol t of key j is bits-wide at shift
    # bits*(per-1-t); reads past the end see the text pad, 2^bits - 1.
    x_ext = torch.cat([x_dense, x_dense.new_full((nk * per,), (1 << bits) - 1)])
    keys = []
    for j in range(nk):
        k = torch.zeros(np_, dtype=torch.int32, device=dev)
        for t in range(per):
            off = j * per + t
            k = (k << bits) | x_ext[off : off + np_]
        keys.append(torch.cat([k, tok_keys[j]]))
    keys = torch.stack(keys)

    # LSD radix: nk stable sorts, least significant key first.  A stable
    # sort of the gathered keys followed by the same reordering of perm
    # is the two-operand stable sort (key, perm) of the reference design.
    perm = torch.arange(nm, dtype=torch.int64, device=dev)
    for j in range(nk):
        _, order = torch.sort(keys[nk - 1 - j][perm], stable=True)
        perm = perm[order]
    idx = torch.arange(nm, dtype=torch.int32, device=dev)
    rank = torch.zeros(nm, dtype=torch.int32, device=dev).scatter_(0, perm, idx)
    return keys, perm, rank


def neighbour_lcp(keys: torch.Tensor, sa: torch.Tensor, *, bits: int, per: int, max_len: int):
    """int32[nm]: LCP between sorted neighbours sa[r], sa[r+1], clamped at
    max_len and read off the keys (0 at the last rank): within key j,
    symbols 0..t of two keys agree iff (a ^ b) >> shift_t == 0."""
    nm = sa.shape[0]
    dev = sa.device
    # (Made on the device: a host list copied to it would wait for the
    # stream.)
    shifts = (torch.arange(per - 1, -1, -1, dtype=torch.int32, device=dev) * bits)[:, None]
    alive = torch.ones(nm, dtype=torch.bool, device=dev)
    lcp = torch.zeros(nm, dtype=torch.int32, device=dev)
    counted = 0
    for j in range(keys.shape[0]):
        if counted >= max_len:
            break
        t_n = min(per, max_len - counted)
        kj = keys[j][sa]
        nxt = torch.cat([kj[1:], kj[-1:]])
        same = (((kj ^ nxt)[None, :] >> shifts[:t_n]) == 0) & alive
        lcp = lcp + same.sum(0, dtype=torch.int32)
        alive = same[-1]
        counted += t_n
    lcp[-1:].zero_()  # (a fill: assigning a Python scalar copies it from the host)
    return lcp


def who_tables(sa: torch.Tensor, np_: int, tok_len, tok_id, tok_kind):
    """(who_len, who_id, who_kind) int32[nm] at every rank, by GATHER:
    sorted element sa[r] >= np_ is token sa[r] - np_; text ranks get
    (0, -1, -1)."""
    is_tok = sa >= np_
    tj = torch.clamp(sa - np_, 0, tok_len.shape[0] - 1)
    return (
        torch.where(is_tok, tok_len[tj], 0),
        torch.where(is_tok, tok_id[tj], -1),
        torch.where(is_tok, tok_kind[tj], -1),
    )


def _linear_batch_compact(*args, cap: int, **kwargs):
    """Compact-output variant: (ONE int32[1 + 2*cap] vector — [count,
    ids[:cap], positions[:cap]] — and the full ids and positions).  A batch
    costs ONE device-to-host copy of the vector; count > cap (capacity
    overflow) is detected on the host, which then copies the full ids and
    positions, left on the device (no second run of the batch)."""
    ids, positions, count = _linear_batch_core(*args, **kwargs)
    fused = torch.cat([count.reshape(1).to(torch.int32), ids[:cap], positions[:cap]])
    return fused, ids, positions


_TORCH_DTYPE = {np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32}


def graph_key(x_dense: np.ndarray, cps_pad: np.ndarray, cap: int) -> tuple:
    """What a batch's CUDA graph is captured for, read off the batch's host
    inputs (LinearEncoder.batch_inputs): the padded length, the compact
    vector's cap and the two transfer dtypes (cps_pad is int32 once the
    batch holds a codepoint above U+FFFF).  The true length is no part of
    it: the batch program runs at the padded length (_encode_batch)."""
    return int(x_dense.shape[0]), int(cap), x_dense.dtype.str, cps_pad.dtype.str


@dataclasses.dataclass
class BatchGraph:
    """One captured batch program: every replay reads the static inputs
    and writes the static compact vector."""

    graph: object  # torch.cuda.CUDAGraph
    x_dense: torch.Tensor
    cps_pad: torch.Tensor
    fused: torch.Tensor


def _capture(run, stream, pool):
    """Capture run() on `stream` into a CUDA graph whose memory comes from
    `pool`.  Returns (graph, run()'s outputs); the capture runs nothing,
    graph.replay() launches the recorded work on the current stream."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = run()
        finally:
            graph.capture_end()
    return graph, out


def _bucket(n: int, floor: int = 128) -> int:
    """Shape buckets {2^k, 3·2^(k-1)}: device cost scales with n, so the
    extra half-step bucket saves up to 25% work vs pure pow2."""
    p2 = max(floor, 1 << (n - 1).bit_length())
    return 3 * (p2 // 4) if n <= 3 * (p2 // 4) else p2


def vocab_tail(vocab: Vocabulary) -> tuple[np.ndarray, np.ndarray]:
    """The vocab part of the reference's S (every token's codepoints, each
    followed by a -1 separator) and each token's start within it, built
    from vocab.flat/offsets without a per-token loop."""
    lens = vocab.lengths.astype(np.int64)
    n_flat = int(vocab.flat.shape[0])
    tail = np.full(n_flat + vocab.size, -1, dtype=np.int32)
    token_of = np.repeat(np.arange(vocab.size, dtype=np.int64), lens)
    tail[np.arange(n_flat, dtype=np.int64) + token_of] = vocab.flat.astype(np.int32)
    starts = vocab.offsets[:-1].astype(np.int64) + np.arange(vocab.size, dtype=np.int64)
    return tail, starts


def build_merge_tables(vocab: Vocabulary, max_len: int) -> dict | None:
    """Per-vocabulary constants of the batch program, as numpy: the dense
    alphabet LUT and the packed per-token sort keys.

    Dense codes: 0 = token pad (sorts below every symbol, playing the
    reference's separator role, src/linear.cpp:87-101), 1..sigma = the
    distinct symbols of eligible tokens, sigma+1 = FOREIGN (every text
    symbol outside the vocab alphabet — sound per the module docstring),
    2^bits - 1 = text pad (sorts above everything).  Returns None when
    the key count would degenerate (huge alphabet x huge max token
    length) — callers fall back to prefix doubling.  Vectorised over the
    tokens: every eligible token's codepoints are gathered from
    vocab.flat in one pass."""
    tok_ids = np.flatnonzero(vocab.active).astype(np.int32)
    nv = int(tok_ids.size)
    lens = vocab.lengths.astype(np.int64)[tok_ids]
    first = np.cumsum(lens) - lens  # each token's start in the gather
    row = np.repeat(np.arange(nv, dtype=np.int64), lens)
    col = np.arange(int(lens.sum()), dtype=np.int64) - first[row]
    cps = vocab.flat[vocab.offsets[:-1][tok_ids][row] + col].astype(np.int64)

    syms = np.unique(cps)
    sigma = int(syms.shape[0])
    foreign = sigma + 1
    bits = max(1, int(sigma + 2).bit_length())  # pad_sym > foreign
    per = max(1, min(30 // bits, max_len))
    nk = -(-max_len // per)
    if nk > 24:
        return None
    lut = np.full(0x110001, foreign, dtype=np.int32)
    lut[syms] = 1 + np.arange(sigma, dtype=np.int32)
    nv_pad = max(128, -(-nv // 128) * 128)
    symmat = np.zeros((nv_pad, nk * per), dtype=np.int32)  # 0 = token pad
    symmat[row, col] = lut[cps]
    keys = np.zeros((nk, nv_pad), dtype=np.int32)
    for j in range(nk):
        for t in range(per):
            keys[j] = (keys[j] << bits) | symmat[:, j * per + t]
    # Pad token rows: every key all-pad (sorts last, pushes nothing).
    keys[:, nv:] = np.int32((1 << min(bits * per, 31)) - 1)
    t_len = np.zeros(nv_pad, dtype=np.int32)
    t_len[:nv] = lens
    t_id = np.full(nv_pad, -1, dtype=np.int32)
    t_id[:nv] = tok_ids
    t_kind = np.full(nv_pad, -1, dtype=np.int32)
    t_kind[:nv] = vocab.is_prefix[tok_ids]
    return {
        "lut": lut,
        "bits": bits,
        "per": per,
        "nk": nk,
        "nv_pad": nv_pad,
        "tok_keys": keys,
        "tok_len": t_len,
        "tok_id": t_id,
        "tok_kind": t_kind,
    }


@dataclasses.dataclass
class MergeTables:
    """Merge tables on a device: the token arrays as tensors, the LUT (a
    host-side gather) and the statics as host values."""

    lut: np.ndarray  # int32[0x110001]
    bits: int
    per: int
    nk: int
    nv_pad: int
    tok_keys: torch.Tensor  # int32[nk, nv_pad]
    tok_len: torch.Tensor  # int32[nv_pad]
    tok_id: torch.Tensor  # int32[nv_pad]
    tok_kind: torch.Tensor  # int32[nv_pad]


def load_merge_tables(tables, device) -> MergeTables | None:
    """Carry merge tables onto `device`.  `tables` is a mapping with the
    keys of build_merge_tables as numpy arrays and ints (this module's, or
    the JAX package's LinearEncoder._merge converted to numpy); None (the
    doubling fallback) stays None."""
    if tables is None:
        return None
    device = torch.device(device)

    def dev(name):
        return torch.from_numpy(np.array(tables[name], dtype=np.int32)).to(device)

    return MergeTables(
        lut=np.asarray(tables["lut"], dtype=np.int32),
        bits=int(tables["bits"]),
        per=int(tables["per"]),
        nk=int(tables["nk"]),
        nv_pad=int(tables["nv_pad"]),
        tok_keys=dev("tok_keys"),
        tok_len=dev("tok_len"),
        tok_id=dev("tok_id"),
        tok_kind=dev("tok_kind"),
    )


class LinearEncoder:
    """Suffix-array WordPiece encoder (host-facing, device-computing)."""

    def __init__(self, vocab: Vocabulary, *, device="cuda"):
        """device: "cuda" (default; raises if no GPU is present) or "cpu".
        Every batch's H2D copies, ops and D2H copy run on one stream owned
        by the encoder; device_batches counts the batch programs run and
        full_fetches the compact-cap overflows (full ids copied back).  On
        a card the batch programs are CUDA graphs, one a graph_key,
        captured on a stream of their own into one memory pool;
        graph_replays counts the batches a replay ran (the kernel wrappers'
        .launches count the others)."""
        self.device = resolve_device(device)
        self.vocab = vocab
        self.max_len = max(vocab.max_len, 1)
        self._tok_lens = vocab.lengths.astype(np.int64)
        self._vocab_tail, self._tok_starts = vocab_tail(vocab)
        self._eligible = vocab.active
        self._kind = np.where(self._eligible, vocab.is_prefix.astype(np.int32), -1)
        self._stream = None
        self._graphs = None  # graph_key -> BatchGraph, on a card
        self._capture_stream = self._graph_pool = None
        self._free_slots: list = []  # pinned staging buffers (_staged)
        # Held from a batch's staging to its D2H enqueued, and around the
        # free slots: callers on several threads share the graphs' static
        # buffers and the slots.
        self._lock = threading.Lock()
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self.device)
            self._graphs = {}
            self._capture_stream = torch.cuda.Stream(device=self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        self._merge = load_merge_tables(build_merge_tables(vocab, self.max_len), self.device)
        if self._stream is not None:
            # The tables were copied on the default stream.
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._unk_id = int(vocab.unk_token_id)
        self._max_text_batch = None
        self.device_batches = 0
        self.graph_replays = 0
        self.full_fetches = 0
        self.stats = None  # optional utils.profiling.StageStats
        self._executor = None  # lazy 1-thread pool for segmentation

    def _stage(self, name, nbytes=0):
        st = self.stats
        return st.stage(name, nbytes) if st is not None else contextlib.nullcontext()

    def _count(self, name: str) -> None:
        if self.stats is not None:
            self.stats.count(name)

    def _batch_ran(self, graph: bool = False) -> None:
        """Count a batch program run; on a card also whether a graph's
        replay ran it (batches_graph) or launches did (batches_eager)."""
        self.device_batches += 1
        self.graph_replays += graph
        if self._graphs is not None:
            self._count("batches_graph" if graph else "batches_eager")

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _staged(self, x_dense: np.ndarray, cps_pad: np.ndarray, out_len: int):
        """The batch's host side: (slot, x, c, host), its inputs as host
        tensors to copy from (uint16 as int16 bits) and the int32[out_len]
        tensor its compact vector comes back into.  On a card all three
        are views of `slot`, one pinned staging buffer, which is the
        batch's until _fetch_batch hands it back, and numpy copies the
        inputs in (a torch CPU copy_, as in pin_memory(), forks torch's
        CPU thread pool: milliseconds a batch on a card's host).  On the
        CPU slot is None and x and c share the arrays' memory."""
        arrs = [a.view(np.int16) if a.dtype == np.uint16 else a for a in (x_dense, cps_pad)]
        if self._stream is None:
            return None, *map(torch.from_numpy, arrs), torch.empty(out_len, dtype=torch.int32)
        sizes = [a.nbytes for a in arrs] + [4 * out_len]
        at = np.cumsum([0] + [-(-b // 16) * 16 for b in sizes]).tolist()  # 16-byte aligned
        slot = self._slot(at[-1])
        raw = slot.numpy()
        for a, a0 in zip(arrs, at):
            raw[a0 : a0 + a.nbytes].view(a.dtype)[:] = a
        x, c = (slot[a0 : a0 + a.nbytes].view(_TORCH_DTYPE[a.dtype]) for a, a0 in zip(arrs, at))
        return slot, x, c, slot[at[2] : at[2] + sizes[2]].view(torch.int32)

    def _slot(self, nbytes: int) -> torch.Tensor:
        """A pinned staging buffer of at least nbytes: the last one freed,
        or a new one in its place where that is smaller (so the slots grow
        to the largest batch seen).  Called under self._lock."""
        slot = self._free_slots.pop() if self._free_slots else None
        if slot is None or slot.numel() < nbytes:
            slot = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return slot

    def _release(self, slot) -> None:
        """A fetched batch's staging buffer, free again: its copies are
        done.  At most PIPELINE_WINDOW + 1 are kept."""
        if slot is not None:
            with self._lock:
                if len(self._free_slots) <= self.PIPELINE_WINDOW:
                    self._free_slots.append(slot)

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        """A staged host tensor on the device, copied asynchronously on the
        current stream."""
        return t if self._stream is None else t.to(self.device, non_blocking=True)

    # Max |S| per internal SA batch.  The reference also batches its
    # linear algorithm (memory_limit/20 "because of SAIS",
    # src/linear.cpp:349); here the bound keeps the sort size in check.
    # Batches split at spaces, so the id stream is exactly the
    # concatenation.
    MAX_S = 1 << 20

    # The plain surviving-slot sweeps materialize [max_len, n] state, so a
    # vocabulary with very long tokens (the reference's 10M-char stress
    # splits produce multi-thousand-char tokens, tests/tests.cpp:264-272)
    # would blow memory.  Such vocabs route to the native scalar encoder
    # over deduped units — identical output semantics, host path.  The
    # CUDA match (csrc/linear_match.cu) keeps no such state; it takes
    # max_len up to this same bound, the JAX package's, so both packages
    # route the same vocabularies.
    MAX_SLOT_LEN = 96

    @property
    def MAX_TEXT_BATCH(self) -> int:
        if self._max_text_batch is not None:
            return self._max_text_batch
        if self._merge is not None:
            # Sorted elements per batch = text positions + one per token.
            return max(1 << 15, self.MAX_S - self._merge.nv_pad)
        return max(1 << 15, self.MAX_S - int(self._vocab_tail.shape[0]) - 64)

    @MAX_TEXT_BATCH.setter
    def MAX_TEXT_BATCH(self, v: int) -> None:
        self._max_text_batch = v

    PIPELINE_WINDOW = 3  # max batches in flight (bounds host + device memory)
    LINEAR_SEG_CHUNK = 3_000_000  # segmentation piece size (bytes)
    LINEAR_BATCH_TARGET = 65536  # cps per device batch (see encode_bytes)

    def encode_bytes(self, data: bytes) -> np.ndarray:
        """Deduped byte path: tokenization is a pure function of each unit
        (engine_word.py has the proof sketch; linear shares the fast
        engine's output semantics, tests/tests.cpp:90-97), so the suffix
        sort runs over the UNIQUE units only, and the id stream is
        recovered with the native expand.

        The corpus segments in LINEAR_SEG_CHUNK pieces on a worker thread
        (a cross-chunk DedupeSession keeps occurrence ids global) while
        the main thread assembles each chunk's first-seen units into
        device batches of about LINEAR_BATCH_TARGET codepoints, keeps at
        most PIPELINE_WINDOW of them in flight and fetches the oldest —
        segmentation, H2D, device work and D2H overlap."""
        with self._stage("encode", len(data)):
            return self._encode_bytes(data)

    def _encode_bytes(self, data: bytes) -> np.ndarray:
        if not loader.available():  # pragma: no cover - native always in CI
            return self.encode_codepoints(np.asarray(uni.decode_utf8(data)))
        if len(data) == 0:
            return np.zeros(0, dtype=np.int32)
        if self.max_len > self.MAX_SLOT_LEN:
            with self._stage("host_segment_dedupe", len(data)):
                occ, ustart, ulen, ucplen = loader.segment_dedupe(data)
            if ustart.shape[0] == 0:
                return np.zeros(0, dtype=np.int32)
            if self.stats is not None:
                self.stats.count("units_new", ustart.shape[0])
                self.stats.count("units_host", ustart.shape[0])
            return self._encode_units_scalar(data, occ, ustart, ulen, ucplen)

        with self._stage("host_split"):
            n = len(data)
            chunks = []
            begin = 0
            while begin < n:
                end = min(n, begin + self.LINEAR_SEG_CHUNK)
                if end < n:
                    cut = uni.find_space_cut(data, end)
                    end = cut if cut >= 0 else n
                chunks.append(data[begin:end])
                begin = end

        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(max_workers=1)

        session = loader.DedupeSession()
        occ_parts: list[np.ndarray] = []
        # Pieces with unconsumed first-seen units, oldest first:
        # [chunk_bytes, nstart, nlen, ncplen, csum(cplen+1), used_ptr].
        pieces: deque = deque()
        pend_cps = 0  # total (cplen + 1) of unconsumed units
        batch_counts: list[np.ndarray] = []  # uid-consecutive batch order
        flats: list[np.ndarray] = []
        window: deque = deque()  # (handle, cstart int64[batch_units + 1])
        # Several batches in flight pipeline H2D, device work and D2H
        # across each other (and start overlapping segmentation earlier).
        target = min(self.LINEAR_BATCH_TARGET, self.MAX_TEXT_BATCH)

        def dispatch_one() -> None:
            """Assemble <= target codepoints of pending units (earliest
            uids first — across pieces) into one device batch."""
            nonlocal pend_cps
            with self._stage("host_join"):
                parts: list[np.ndarray] = []
                ucls: list[np.ndarray] = []
                got = 0
                for p in list(pieces):  # each piece once, oldest first
                    if got >= target:
                        break
                    pb, ns, nl, ncl, cs, used = p
                    u1 = int(np.searchsorted(cs, cs[used] + (target - got), side="right")) - 1
                    u1 = min(max(u1, used + 1), ns.shape[0])
                    parts.append(
                        loader.join_units_cps(pb, ns, nl, used, u1, int(cs[u1] - cs[used] - 1))
                    )
                    ucls.append(ncl[used:u1].astype(np.int64))
                    got += int(cs[u1] - cs[used])
                    p[5] = u1
                while pieces and pieces[0][5] >= pieces[0][1].shape[0]:
                    pieces.popleft()  # consumed pieces are the oldest
                pend_cps -= got
                if not parts:
                    return
                if len(parts) == 1:
                    cps = parts[0]
                else:  # single space between pieces (units never touch)
                    sep = np.full(1, 32, dtype=parts[0].dtype)
                    joined: list[np.ndarray] = []
                    for i, part in enumerate(parts):
                        if i:
                            joined.append(sep)
                        joined.append(part)
                    cps = np.concatenate(joined)
                ucl_b = np.concatenate(ucls)
                cstart = np.zeros(ucl_b.shape[0] + 1, dtype=np.int64)
                np.cumsum(ucl_b + 1, out=cstart[1:])
            if self.stats is not None:
                self.stats.count("units_card", ucl_b.shape[0])
            if len(window) >= self.PIPELINE_WINDOW:
                finish_one()
            with self._stage("device_dispatch"):
                handle = self._encode_batch(cps, as_handle=True)
            window.append((handle, cstart))

        def finish_one() -> None:
            handle, cstart = window.popleft()
            with self._stage("device_fetch"):
                ids, positions = self._fetch_batch(handle)
            with self._stage("host_stitch"):
                # Attribute each emitted id to its unit (positions ascend).
                unit_of = np.searchsorted(cstart[:-1], positions, side="right") - 1
                batch_counts.append(
                    np.bincount(unit_of, minlength=cstart.shape[0] - 1).astype(np.int64)
                )
            flats.append(np.asarray(ids, dtype=np.int32))

        # The caller waits on this worker for most of a call, so its scan
        # takes the host's cores (the word engine keeps two, engine_word.py).
        seg_threads = loader.wide_n_threads()

        def seg_chunk(chunk: bytes):
            with self._stage("host_segment_dedupe", len(chunk)):
                out = session.segment(chunk, threads=seg_threads)
            if self.stats is not None:
                self.stats.count("segment_parts", session.last_parts)
                self.stats.count("segment_pending", session.last_pending)
            return out

        seg_futs = []
        try:
            seg_futs = [self._executor.submit(seg_chunk, c) for c in chunks]
            for fut, chunk in zip(seg_futs, chunks):
                with self._stage("wait_worker"):
                    occ_k, ns, nl, ncl = fut.result()
                if occ_k.shape[0]:
                    occ_parts.append(occ_k)
                if self.stats is not None:
                    self.stats.count("units_new", ns.shape[0])
                if ns.shape[0]:
                    cs = np.zeros(ns.shape[0] + 1, dtype=np.int64)
                    np.cumsum(ncl.astype(np.int64) + 1, out=cs[1:])
                    pieces.append([chunk, ns, nl, ncl, cs, 0])
                    pend_cps += int(cs[-1])
                while pend_cps >= target:
                    dispatch_one()
            while pend_cps > 0:
                dispatch_one()
            while window:
                finish_one()
        finally:
            # No segmentation may outlive the session.
            for fut in seg_futs:
                fut.cancel()
            for fut in seg_futs:
                if not fut.cancelled():
                    fut.exception()
            session.close()

        if not occ_parts:
            return np.zeros(0, dtype=np.int32)
        with self._stage("host_concat"):
            occ = occ_parts[0] if len(occ_parts) == 1 else np.concatenate(occ_parts)
            counts_u = np.concatenate(batch_counts) if batch_counts else np.zeros(0, np.int64)
            offsets = np.zeros(counts_u.shape[0] + 1, dtype=np.int64)
            np.cumsum(counts_u, out=offsets[1:])
            tok_flat = np.concatenate(flats) if flats else np.zeros(0, np.int32)
        with self._stage("host_expand"):
            out = loader.expand(occ, tok_flat, offsets)
        return out if out is not None else np.zeros(0, np.int32)

    # Compact-output capacity as a fraction of batch codepoints.  Emitted
    # ids never exceed the batch's codepoint count (every id consumes at
    # least one codepoint; a rolled-back word emits ONE UNK), so the cap
    # never needs to exceed n.  The ratio ratchets upward per encoder when
    # a corpus emits denser id streams (CJK singles), trading a few extra
    # D2H bytes for avoiding the overflow copy; it never decays, as in
    # the JAX package.  The initial value sits just above en/ru
    # unique-batch density (~0.26).
    _cap_ratio = 0.32

    def _out_cap(self, n: int) -> int:
        want = int(n * self._cap_ratio) + 4096
        return min(_bucket(max(8192, want)), _bucket(n))

    def _fetch_batch(self, handle):
        """-> (ids np.int32[count], positions np.int32[count])."""
        if handle[0] == "full":  # doubling fallback: device triple
            _, ids, positions, count = handle
            with self._on_stream():
                with self._stage("device_wait"):
                    count = int(count)
                with self._stage("fetch_unpack"):
                    return ids[:count].cpu().numpy(), positions[:count].cpu().numpy()
        _, host, event, cap, n, full, slot = handle
        with self._stage("device_wait"):
            if event is not None:
                event.synchronize()
        with self._stage("fetch_unpack"):
            f = host.numpy()
            count = int(f[0])
            # Adapt the cap ratio toward the observed density (+15% headroom).
            if n:
                ratio = min(1.0, count / n * 1.15)
                if ratio > self._cap_ratio:
                    self._cap_ratio = ratio
            if count <= cap:
                out = f[1 : 1 + count].copy(), f[1 + cap : 1 + cap + count].copy()
            else:
                # Capacity overflow (id stream denser than cap): copy the
                # full ids and positions, which the handle kept on the
                # device or, for a graph's batch, runs again.
                self.full_fetches += 1
                with self._on_stream():
                    ids, positions = full()
                    out = ids[:count].cpu().numpy(), positions[:count].cpu().numpy()
        self._release(slot)
        return out

    def _encode_units_scalar(self, data, occ, ustart, ulen, ucplen) -> np.ndarray:
        """Long-token vocab route: native scalar encode of each unique
        unit, expanded to the occurrence stream (see MAX_SLOT_LEN)."""
        if not hasattr(self, "_scalar"):
            self._scalar = loader.VocabHandle(self.vocab)
        flat, counts = self._scalar.encode_units(data, ustart, ulen, int(ucplen.sum()))
        offsets = np.zeros(counts.shape[0] + 1, dtype=np.int64)
        np.cumsum(counts.astype(np.int64), out=offsets[1:])
        out = loader.expand(occ, flat, offsets)
        return out if out is not None else np.zeros(0, np.int32)

    def encode_codepoints(self, cps: np.ndarray) -> np.ndarray:
        cps = np.asarray(cps, dtype=np.int32)
        n = int(cps.shape[0])
        if n == 0:
            return np.zeros(0, dtype=np.int32)
        if self.max_len > self.MAX_SLOT_LEN:
            if loader.available():
                return self.encode_bytes(bytes(uni.encode_utf8(cps.astype(np.uint32))))
            # Without the native runtime, small inputs still work through
            # the device path (tests); big ones are better off failing
            # loudly than silently allocating n * max_len slots.
            if n * self.max_len > 1 << 26:
                raise ValueError(
                    "vocabulary max token length "
                    f"{self.max_len} needs the native runtime for inputs "
                    "this large (surviving-slot state would exceed memory)"
                )
        if n > self.MAX_TEXT_BATCH:
            space = np.asarray(uni.is_space(cps.astype(np.uint32)))
            outs = []
            begin = 0
            while begin < n:
                end = min(n, begin + self.MAX_TEXT_BATCH)
                while end < n and not space[end]:
                    end += 1
                outs.append(self._encode_batch(cps[begin:end]))
                begin = end
            return np.concatenate(outs) if outs else np.zeros(0, np.int32)
        return self._encode_batch(cps)

    def batch_inputs(self, cps: np.ndarray):
        """Host side of one batch: (x_dense, cps_pad, cap).

        Dense text symbols via the per-vocab LUT (one gather on host); pad
        = 2^bits - 1 (sorts last, pushes no tokens, the commit never
        visits it).  Raw codepoints pad as spaces (skipped by the walk).
        One shared pad length buckets both arrays.  Both are uint16 when
        values fit (pad included); the device widens."""
        n = int(cps.shape[0])
        m = self._merge
        np_ = _bucket(n)
        pad_sym = (1 << m.bits) - 1
        x_dense = np.full(np_, pad_sym, dtype=np.uint16 if pad_sym <= 0xFFFF else np.int32)
        x_dense[:n] = m.lut[np.clip(cps, 0, 0x110000)]
        cdt = np.uint16 if (n == 0 or int(cps.max()) <= 0xFFFF) else np.int32
        cps_pad = np.full(np_, 32, dtype=cdt)
        cps_pad[:n] = cps
        return x_dense, cps_pad, self._out_cap(n)

    def _encode_batch(self, cps: np.ndarray, as_handle: bool = False):
        """One text batch.  as_handle=True returns a handle for
        _fetch_batch (the pipelined path: the work is only enqueued);
        otherwise returns the batch's ids as a host array.

        On a card the batch replays the CUDA graph of its graph_key: the
        staged inputs are copied into the graph's static inputs, the
        replay follows, then the compact vector's copy into the batch's
        pinned staging buffer and its event, all on the encoder's stream
        (so a batch's copy is done before the next replay overwrites the
        static vector).  A key's first batch runs as launches and then
        captures the graph, with its device inputs as the static ones."""
        n = int(cps.shape[0])
        if self._merge is None:  # huge alphabet x huge token
            with self._on_stream():
                out = self._encode_batch_doubling(cps, with_positions=as_handle)
            return ("full",) + tuple(out) if as_handle else out

        x_dense, cps_pad, cap = self.batch_inputs(cps)
        with self._stage("batch_enqueue"), self._lock, self._on_stream():
            slot, *staged, host = self._staged(x_dense, cps_pad, 1 + 2 * cap)
            key = graph_key(x_dense, cps_pad, cap)
            g = self._graphs.get(key) if self._graphs is not None else None
            if g is not None:
                g.x_dense.copy_(staged[0], non_blocking=True)
                g.cps_pad.copy_(staged[1], non_blocking=True)
                g.graph.replay()
                self._batch_ran(graph=True)
                fused = g.fused

                def full():
                    # The static buffers may hold a later batch by now.
                    return self._run_batch(*map(self._to_device, staged), cap)[1:]
            else:
                x_d, c_d = map(self._to_device, staged)
                fused, ids, positions = self._run_batch(x_d, c_d, cap)

                def full():
                    return ids, positions

                if self._graphs is not None:
                    self._graphs[key] = self._capture_batch(x_d, c_d, cap)
            host.copy_(fused, non_blocking=True)  # ONE D2H transfer
            event = None
            if self._stream is not None:
                event = torch.cuda.Event()
                event.record(self._stream)
        handle = ("compact", host, event, cap, n, full, slot)
        if as_handle:
            return handle
        return self._fetch_batch(handle)[0]

    def _program(self, x_d: torch.Tensor, c_d: torch.Tensor, cap: int):
        """The batch program on device inputs, on the current stream:
        (fused, ids, positions) of _linear_batch_compact.  It runs at the
        padded length: the pads are spaces in c_d and the pad symbol in
        x_d, which sorts after every token, matches nothing and which the
        commit skips, so the ids, positions and count are the true
        length's, and one graph serves every length of a bucket."""
        m = self._merge
        return _linear_batch_compact(
            x_d, c_d, int(x_d.shape[0]), m.tok_keys, m.tok_len, m.tok_id, m.tok_kind,
            bits=m.bits, per=m.per, nk=m.nk, max_len=self.max_len, unk_id=self._unk_id, cap=cap,
        )

    def _run_batch(self, x_d: torch.Tensor, c_d: torch.Tensor, cap: int):
        """_program as launches, counted as a batch run."""
        out = self._program(x_d, c_d, cap)
        self._batch_ran()
        return out

    def _capture_batch(self, x_d: torch.Tensor, c_d: torch.Tensor, cap: int) -> BatchGraph:
        """The graph of _program with x_d and c_d as its static inputs.  The
        batch that brings a key runs as launches first, which builds each
        kernel's library before the capture.  The capture runs nothing, and
        the kernel wrappers count no launch inside it."""
        graph, (fused, _, _) = _capture(lambda: self._program(x_d, c_d, cap),
                                        self._capture_stream, self._graph_pool)
        self._count("graph_captures")
        return BatchGraph(graph, x_d, c_d, fused)

    def doubling_string(self, cps: np.ndarray) -> np.ndarray:
        """The fallback's S, int32[_bucket(|S|)]: text · -1 · the vocab
        tail, then distinct pad symbols above every codepoint."""
        s_core = np.concatenate([cps, np.array([-1], dtype=np.int32), self._vocab_tail])
        n_core = s_core.shape[0]
        pad_base = int(max(int(s_core.max()), 0x110000)) + 1
        return np.concatenate(
            [s_core, pad_base + np.arange(_bucket(n_core) - n_core, dtype=np.int32)]
        ).astype(np.int32)

    def _encode_batch_doubling(self, cps: np.ndarray, with_positions: bool = False):
        """Fallback batch using the prefix-doubling SA (kept for alphabets
        x token lengths where the packed k-gram keys would degenerate).
        Runs on the current stream; reads the ranks back to the host."""
        n = int(cps.shape[0])
        sa_tables, feats = self.doubling_inputs(cps)
        best_id, best_len = match_from_sa(*sa_tables, feats.window, feats.wp,
                                          max_len=self.max_len)
        self._batch_ran()
        ids, positions, count = commit_ops.commit_with_positions(best_id, best_len, feats, n,
                                                                 unk_id=self._unk_id)
        if with_positions:
            return ids, positions, count
        return ids[: int(count)].cpu().numpy()

    def doubling_inputs(self, cps: np.ndarray):
        """The fallback batch up to the match, on the encoder's device: the
        suffix array and LCP of doubling_string(cps), the who-tables at the
        tokens' start ranks (read back to the host) and the text features.
        Returns ((rank, lcp, who_len, who_id, who_kind), feats), as
        batch_match_inputs."""
        n = int(cps.shape[0])
        s_host = self.doubling_string(cps)
        n_s = s_host.shape[0]

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        s_dev = dev(s_host)
        sa, rank = suffix_array(s_dev)
        lcp = lcp_clamped(s_dev, sa, clamp=self.max_len)

        rank_np = rank.cpu().numpy()
        who_len = np.zeros(n_s, dtype=np.int32)
        who_id = np.full(n_s, -1, dtype=np.int32)
        who_kind = np.full(n_s, -1, dtype=np.int32)
        tok_rank = rank_np[(n + 1 + self._tok_starts).astype(np.int64)]
        sel = self._eligible
        who_len[tok_rank[sel]] = self._tok_lens[sel]
        who_id[tok_rank[sel]] = np.arange(self.vocab.size, dtype=np.int32)[sel]
        who_kind[tok_rank[sel]] = self._kind[sel]

        cps_pad = np.full(_bucket(n), 32, dtype=np.int32)
        cps_pad[:n] = cps
        feats = compute_features(dev(cps_pad), n, self.max_len)
        return (rank, lcp, dev(who_len), dev(who_id), dev(who_kind)), feats
