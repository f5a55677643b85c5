"""Public API: the PyTorch/CUDA counterpart of wordpiece_tpu's api.py.

Reference surface (src/word_piece.hpp:1-38):
  word_piece::fast::encode(text, vocab) / encode(text_file, vocab_file)
  word_piece::fast::decode(vocab_file, ids)
  word_piece::fast::encodeExternal(text_file, vocab_file, out_file, limit)
  word_piece::linear::{encode, encodeExternal}

`fast` runs the word engine (engine_word.WordEncoder) on the card.  Every
entry point that reaches the device takes `device=`: "cuda" (the
default; raises when no GPU is present) or "cpu".  The `linear` engine
and the `fast-stream` engine are not ported yet and raise
NotImplementedError; nothing falls back silently to another engine.

Encoder instances cache the built kernel and the vocab's device tables;
the module-level helpers mirror the reference's one-shot calls.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Iterable, Sequence

import numpy as np

from .core import unicode as uni
from .core.oracle import encode_oracle
from .core.vocab import Vocabulary, parse_vocab, read_vocab_file

# Bounded LRU of module-namespace encoders.  Entries hold the encoder
# (which holds the vocab — so id(vocab) keys stay valid while cached);
# evicting the LRU entry releases device tables and native handles.
_ENCODER_CACHE: OrderedDict[tuple, object] = OrderedDict()
_ENCODER_CACHE_MAX = 8

_NOT_PORTED = {
    "linear": "the linear engine is not ported yet (ROADMAP.md, queue A, item 1)",
    "fast-stream": "the fast-stream engine is not ported yet (ROADMAP.md, queue A, item 2)",
}


def _as_vocab(vocab: Sequence[str] | Vocabulary | str) -> Vocabulary:
    if isinstance(vocab, Vocabulary):
        return vocab
    if isinstance(vocab, str):
        return read_vocab_file(vocab)
    return parse_vocab(list(vocab))


def _read_text(text_file: str) -> bytes:
    with open(text_file, "rb") as f:
        return f.read()


def _vocab_fingerprint(v: Vocabulary) -> int:
    """Cheap content fingerprint of a vocabulary (resume guard)."""
    import zlib

    fp = zlib.crc32(np.ascontiguousarray(v.flat, np.uint32).tobytes())
    return zlib.crc32(np.ascontiguousarray(v.offsets, np.int64).tobytes(), fp)


def _file_fingerprint(path: str) -> int:
    """Cheap corpus fingerprint: crc32 of the first and last 64KB."""
    import zlib

    fp = 0
    with open(path, "rb") as tf:
        fp = zlib.crc32(tf.read(1 << 16), fp)
        sz = os.path.getsize(path)
        if sz > (1 << 16):
            tf.seek(max(0, sz - (1 << 16)))
            fp = zlib.crc32(tf.read(1 << 16), fp)
    return fp


def write_ids_file(path: str, ids: Iterable[int]) -> None:
    """writeToFile (src/utils.cpp:30-35): ids as 'id ' text."""
    with open(path, "w") as f:
        for i in ids:
            f.write(f"{int(i)} ")


def _encode_with(enc, raw: bytes) -> np.ndarray:
    if hasattr(enc, "encode_bytes"):
        return enc.encode_bytes(raw)
    return enc.encode_codepoints(uni.decode_utf8(raw).astype(np.int32))


class _FastNamespace:
    """The `fast` namespace: encode / encode_text / encode_file /
    encode_external / decode."""

    _engine_name = "fast"

    def _encoder(self, vocab: Vocabulary, device):
        key = (self._engine_name, id(vocab), str(device))
        enc = _ENCODER_CACHE.get(key)
        if enc is None:
            enc = make_encoder(vocab, engine=self._engine_name, device=device)
            _ENCODER_CACHE[key] = enc
            while len(_ENCODER_CACHE) > _ENCODER_CACHE_MAX:
                _ENCODER_CACHE.popitem(last=False)
        else:
            _ENCODER_CACHE.move_to_end(key)
        return enc

    def encode(
        self, text: str | bytes, vocab: Sequence[str] | Vocabulary | str, *, device="cuda"
    ) -> list[int]:
        """encode(text, vocab) / encode(text_file, vocab_file).

        WARNING — data-dependent dispatch: mirroring the reference's two
        overloads (word_piece.hpp:12,14) in one Python entry point, a
        `str` that names an EXISTING file is read as a file; any other
        input is encoded literally.  Use ``encode_text`` /
        ``encode_file`` to pin the interpretation.
        """
        if isinstance(text, str) and os.path.exists(text):
            return self.encode_file(text, vocab, device=device)
        return self.encode_text(text, vocab, device=device)

    def encode_text(
        self, text: str | bytes, vocab: Sequence[str] | Vocabulary | str, *, device="cuda"
    ) -> list[int]:
        """Encode `text` literally (never interpreted as a path)."""
        raw = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        return self._encode_raw(raw, vocab, device)

    def encode_file(
        self, text_file: str, vocab: Sequence[str] | Vocabulary | str, *, device="cuda"
    ) -> list[int]:
        """Encode the contents of `text_file` (must exist)."""
        return self._encode_raw(_read_text(text_file), vocab, device)

    def _encode_raw(self, raw: bytes, vocab, device) -> list[int]:
        v = _as_vocab(vocab)
        return _encode_with(self._encoder(v, device), raw).tolist()

    def encode_external(
        self,
        text_file: str,
        vocab_file: str | Vocabulary,
        out_file: str,
        memory_limit: int,
        *,
        resume: bool = False,
        device="cuda",
    ) -> None:
        """Out-of-core batch loop (src/fast.cpp:189-220).

        Batches are extended so that each ends on a space character,
        guaranteeing no token crosses a batch boundary
        (starts_with_space check, src/fast.cpp:205-207).  The corpus is
        mmap'd (like the reference's boost mapped_file) so peak memory is
        one batch, not the file.

        Beyond the reference: batch-granular CHECKPOINT/RESUME.  After
        every completed batch a sidecar ``out_file + ".state"`` records
        (input offset, output bytes); ``resume=True`` truncates a
        partially-written batch and continues from the last checkpoint.
        The state file is removed on successful completion.
        """
        import json
        import mmap

        v = _as_vocab(vocab_file)
        enc = self._encoder(v, device)

        # Cheap content fingerprints guarding resume: a changed vocab (or
        # an edited same-size corpus) must refuse to append ids after a
        # prefix produced under different inputs.
        vocab_fp = _vocab_fingerprint(v)
        text_fp = _file_fingerprint(text_file)
        # Reference budget: /2 for fast (src/fast.cpp:195).
        max_batch = max(memory_limit // 2, 1)
        size = os.path.getsize(text_file)
        state_path = out_file + ".state"

        begin = 0
        out_mode = "w"
        if resume and os.path.exists(state_path) and os.path.exists(out_file):
            try:
                with open(state_path) as f:
                    st = json.load(f)
            except (OSError, ValueError):
                st = None
            if (
                st
                and st.get("text_size") == size
                and st.get("memory_limit") == memory_limit
                and st.get("engine") == self._engine_name
                and st.get("vocab_fp") == vocab_fp
                and st.get("text_fp") == text_fp
            ):
                begin = int(st["offset"])
                with open(out_file, "r+") as fout:
                    fout.truncate(int(st["out_bytes"]))
                out_mode = "a"

        if size == 0:
            open(out_file, out_mode).close()
            if os.path.exists(state_path):
                os.remove(state_path)
            return

        with open(text_file, "rb") as f, mmap.mmap(
            f.fileno(), 0, access=mmap.ACCESS_READ
        ) as data, open(out_file, out_mode) as fout:
            out_bytes = fout.tell() if out_mode == "a" else 0
            while begin < size:
                remaining = size - begin
                if remaining > max_batch:
                    batch = max_batch
                    while batch < remaining and not uni.starts_with_space(
                        data[begin + batch - 1 : begin + batch + 3]
                    ):
                        batch += 1
                else:
                    batch = remaining
                ids = _encode_with(enc, data[begin : begin + batch])
                text = "".join(f"{i} " for i in ids.tolist())
                fout.write(text)
                fout.flush()
                out_bytes += len(text)
                begin += batch
                with open(state_path, "w") as sf:
                    json.dump(
                        {
                            "text_size": size,
                            "memory_limit": memory_limit,
                            "engine": self._engine_name,
                            "offset": begin,
                            "out_bytes": out_bytes,
                            "vocab_fp": vocab_fp,
                            "text_fp": text_fp,
                        },
                        sf,
                    )
        os.remove(state_path)

    def decode(self, vocab_file: str | Vocabulary, ids: Sequence[int]) -> list[str]:
        """ids -> token strings (src/fast.cpp:165-187).

        Suffix tokens are re-prefixed with "##"; out-of-range and
        malformed ids are skipped with a warning (the reference's
        bounds check has an off-by-one, `> size` at src/fast.cpp:171,
        which we correct to `>=`).
        """
        import sys

        v = _as_vocab(vocab_file)
        out: list[str] = []
        for i in ids:
            i = int(i)
            if i < 0 or i >= v.size:
                print(f"no token {i}", file=sys.stderr)
                continue
            if v.is_malformed[i]:
                print("trying to access malformed token", file=sys.stderr)
                continue
            s = uni.encode_utf8(v.word(i)).decode("utf-8", errors="replace")
            out.append(s if v.is_prefix[i] else "##" + s)
        return out


class _NotPortedNamespace:
    """A namespace whose engine is not ported yet: every call raises."""

    def __init__(self, engine_name: str):
        self._engine_name = engine_name

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        raise NotImplementedError(_NOT_PORTED[self._engine_name])


class _HostEncoder:
    """The native C++ scalar oracle as an engine."""

    def __init__(self, v: Vocabulary):
        from .runtime import loader

        self.vocab = v
        self._h = loader.VocabHandle(v)

    def encode_codepoints(self, cps):
        return self._h.encode(cps)


class _OracleEncoder:
    """The pure-Python reference oracle as an engine."""

    def __init__(self, v: Vocabulary):
        self.vocab = v

    def encode_codepoints(self, cps):
        return np.asarray(encode_oracle(cps, self.vocab), dtype=np.int32)


def make_encoder(
    vocab: Vocabulary, engine: str = "fast", *, cache: bool = False, device="cuda"
):
    """engine: "fast" (the word engine on `device`), "host" or "oracle"
    (host engines; `device` does not apply).  cache=True (fast engine
    only) keeps a vocabulary-lifetime unit cache across encode calls —
    see WordEncoder.  Requesting a cache on an engine that cannot honor
    it is an error, not a silent downgrade."""
    if engine in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[engine])
    if cache and engine != "fast":
        raise ValueError(f"cache=True is only supported by engine='fast', not {engine!r}")
    if engine == "fast":
        from .engine_word import WordEncoder

        # Production policy "auto": the device path is primary, but each
        # blocking fetch runs under a deadline on a worker thread; a fetch
        # that times out is RESCUED by the host oracle (identical ids).
        # See WordEncoder.__init__'s docstring for the full policy.
        return WordEncoder(vocab, cache=cache, device_role="auto", device=device)
    if engine == "host":
        return _HostEncoder(vocab)
    if engine == "oracle":
        return _OracleEncoder(vocab)
    raise ValueError(f"unknown engine: {engine}")


fast = _FastNamespace()
linear = _NotPortedNamespace("linear")
