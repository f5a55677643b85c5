"""The port's native runtime (wordpiece_tpu_torch/runtime/native) under
hardening: a forced-scalar A/B and an ASan+UBSan run of every entry point.

The counterpart of tests/test_native_sanitize.py, which builds the JAX
package's copy; this one builds the port's own.  Mirrors the reference's
opt-in sanitizer build (-DCMAKE_USE_SANITIZERS, reference
CMakeLists.txt:39-45).  The library does raw pointer arithmetic,
deliberate over-reads (wp_expand), AVX-512 class masks and thread_local
scratch reuse across two threads — the code sanitizers exist for.

Each build runs in a subprocess that selects it with
WORDPIECE_TPU_TORCH_NATIVE_SO, so the library this test process has loaded
is never swapped under it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from wordpiece_tpu_torch.runtime import loader

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not loader.available(), reason="native runtime required")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(ROOT, "wordpiece_tpu_torch", "runtime", "native")
SOURCES = (os.path.join(NATIVE_DIR, "wordpiece_host.cc"), os.path.join(NATIVE_DIR, "Makefile"))
# Sizes straddling the 64-byte class-mask block and the scalar tail.
SIZES = (0, 1, 63, 64, 65, 127, 128, 129, 1000, 4096, 1 << 17)


def _build(so_name: str) -> str:
    so = os.path.join(NATIVE_DIR, so_name)
    assert loader.ensure_built(NATIVE_DIR, so, SOURCES), f"make {so_name} failed"
    return so


def _run(script: str, so_name: str, *args, env=None, timeout=300):
    """Run `script` in a fresh interpreter on the library `so_name`."""
    e = dict(os.environ)
    e.update(env or {})
    e["WORDPIECE_TPU_TORCH_NATIVE_SO"] = so_name
    return subprocess.run(
        [sys.executable, "-c", script, *args],
        capture_output=True,
        text=True,
        timeout=timeout,
        env=e,
        cwd=ROOT,
    )


# Shared by both scripts: ASCII words, punctuation, every space class
# (tab, newline, U+2581), Cyrillic, CJK, kana, a 4-byte emoji, Latin-1
# punctuation and invalid bytes — adversarial for the class masks,
# the pair-class table and the single-codepoint maps.
_CORPUS = r'''
import numpy as np

WORDS = [b"alpha", b"x", b"beta9", b"-", b".", b",,", b"\xd0\xbf\xd1\x80",
         b"\xe4\xb8\xad\xe6\x96\x87", b"\xe2\x96\x81tok", b"mixed\xc3\xa9",
         b"\xe3\x81\x82\xe3\x81\x84", b"\xf0\x9f\x98\x80", b"\xc2\xabq\xc2\xbb",
         b"\xff", b"ab\x80cd"]
SEPS = [b"", b" ", b"  ", b"\n", b"\t", b"\xe2\x96\x81"]


def mixed_bytes(rng, n):
    parts, total = [], 0
    while total < n:
        w = WORDS[int(rng.integers(0, len(WORDS)))]
        s = SEPS[int(rng.integers(0, len(SEPS)))]
        parts += [w, s]
        total += len(w) + len(s)
    return b"".join(parts)[:n]


def two_chunks(data):
    """data cut at the first space at or after its middle."""
    mid = data.index(b" ", len(data) // 2)
    return data[:mid], data[mid:]


def token_lists(n_units):
    """1-3 made-up ids per unit -> (flat, offsets)."""
    counts = (np.arange(n_units, dtype=np.int64) % 3) + 1
    offs = np.zeros(n_units + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    return np.arange(offs[-1], dtype=np.int32), offs
'''

_AB_SCRIPT = _CORPUS + r'''
import os
import sys

from wordpiece_tpu_torch.runtime import loader

lib = loader._load()
assert lib is not None and os.path.basename(lib._name) == os.environ["WORDPIECE_TPU_TORCH_NATIVE_SO"]
rng = np.random.default_rng(42)
out = {}
for size in [int(a) for a in sys.argv[2].split(",")]:
    for k, a in zip(("occ", "start", "len", "cplen"), loader.segment_dedupe(mixed_bytes(rng, size))):
        out[f"{k}{size}"] = a
# One session over two chunks of >= 1 MB each, so each chunk's scan runs
# in two halves; then expand over both chunks' occurrences (>= 2^18 of
# them: the two-thread expand).
loader.set_n_threads(2)
data = mixed_bytes(rng, 3 << 20)
s = loader.DedupeSession()
for i, chunk in enumerate(two_chunks(data)):
    for k, a in zip(("occ", "start", "len", "cplen"), s.segment(chunk)):
        out[f"session{i}_{k}"] = a
n_total = s.n_total
s.close()
occ = np.concatenate([out["session0_occ"], out["session1_occ"]])
assert occ.shape[0] >= 1 << 18
flat, offs = token_lists(n_total)
out["expand"] = loader.expand(occ, flat, offs)
out["expand_slack"] = loader.expand(occ, np.concatenate([flat, np.zeros(2, np.int32)]), offs, slack=True)
np.savez(sys.argv[1], **out)
print("AB_SCRIPT_OK", n_total)
'''


def test_forced_scalar_build_segments_and_expands_as_the_default_build(tmp_path):
    """The WP_FORCE_SCALAR build (no AVX-512 class masks) is the oracle of
    the default build: a fresh session over each size, one session over
    two chunks, and the expand of that session, array for array."""
    _build("libwordpiece_host.so")
    _build("libwordpiece_host_scalar.so")
    sizes = ",".join(map(str, SIZES))
    got = {}
    for so_name in ("libwordpiece_host.so", "libwordpiece_host_scalar.so"):
        path = str(tmp_path / f"{so_name}.npz")
        r = _run(_AB_SCRIPT, so_name, path, sizes)
        assert r.returncode == 0 and "AB_SCRIPT_OK" in r.stdout, r.stderr[-3000:]
        got[so_name] = dict(np.load(path))
    want, scalar = got["libwordpiece_host.so"], got["libwordpiece_host_scalar.so"]
    assert sorted(want) == sorted(scalar)
    assert want["occ131072"].shape[0] > 10_000 and want["session1_start"].shape[0] > 0
    for key in want:
        np.testing.assert_array_equal(scalar[key], want[key], err_msg=key)


_SAN_SCRIPT = _CORPUS + r'''
from wordpiece_tpu_torch.core.vocab import parse_vocab
from wordpiece_tpu_torch.runtime import loader

assert loader.available(), "sanitizer library failed to load"
rng = np.random.default_rng(3)
corpus = mixed_bytes(rng, 3 << 20)
vocab = parse_vocab(["[UNK]", "alpha", "x", "beta", "##9", "-", ".", "п", "##р",
                     "中", "文", "mixed", "tok", "##é", "あ", "##い", "q"])

cps = loader.decode_utf8(corpus)
occ, us, ul, ucp = loader.segment_dedupe(corpus[:100_000])
# Two threads: chunks of >= 1 MB scan in two halves, expand splits in two.
loader.set_n_threads(2)
s = loader.DedupeSession()
outs, begin = [], 0
while begin < len(corpus):
    end = min(len(corpus), begin + 1_200_000)
    while end < len(corpus) and corpus[end] != 0x20:
        end += 1
    outs.append(s.segment(corpus[begin:end]))
    begin = end
n_total = s.n_total
s.close()
assert len(outs) >= 3

h = loader.VocabHandle(vocab)
ids = h.encode(cps[:100_000])
k = min(500, us.shape[0])
flat, counts = h.encode_units(corpus, us[:k], ul[:k], int(ucp[:k].sum()))
offs = np.zeros(k + 1, np.int64)
np.cumsum(counts.astype(np.int64), out=offs[1:])
exp = loader.expand(occ[occ < k], flat, offs)

big_occ = np.concatenate([o[0] for o in outs])
assert big_occ.shape[0] >= 1 << 18
tflat, toffs = token_lists(n_total)
want = np.concatenate([tflat[toffs[u]:toffs[u + 1]] for u in big_occ[:2000]])
e1 = loader.expand(big_occ, tflat, toffs)
e2 = loader.expand(big_occ, np.concatenate([tflat, np.zeros(2, np.int32)]), toffs, slack=True)
assert np.array_equal(e1, e2) and np.array_equal(e1[:want.shape[0]], want)

joined = loader.join_units_cps(corpus, us, ul, 0, k, int(ucp[:k].sum()) + k - 1)
mats, b_of, r_of = loader.bucket_fill(corpus, us, ul, ucp, [7, 15, 31, 127])
n_bad = 0
for b, m in enumerate(mats):
    if m.shape[0]:
        emit = np.full(m.shape, -2, np.int32)
        emit[:, 0] = 0
        emit[0, 0] = 1  # "alpha" does not match the first row: a bad row
        n_bad += loader.verify_emit(m, emit, vocab, 0).shape[0]
assert n_bad >= 1
print("SAN_SCRIPT_OK", len(ids), int(exp.shape[0]), int(e1.shape[0]), int(joined.shape[0]), n_bad)
'''


@pytest.mark.slow
def test_sanitizer_run():
    """Every entry point the port's loader binds, under ASan+UBSan in a
    subprocess (LD_PRELOAD of libasan into a stock python)."""
    _build("libwordpiece_host_san.so")
    asan = subprocess.run(
        ["g++", "-print-file-name=libasan.so"], capture_output=True, text=True
    ).stdout.strip()
    if not asan or not os.path.exists(asan):
        pytest.skip("libasan not found")
    r = _run(
        _SAN_SCRIPT,
        "libwordpiece_host_san.so",
        env=dict(
            LD_PRELOAD=asan,
            # Python itself leaks by design; we want memory errors, not leaks.
            ASAN_OPTIONS="detect_leaks=0,abort_on_error=1",
        ),
        timeout=900,
    )
    assert r.returncode == 0, f"sanitizer run failed:\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}"
    assert "SAN_SCRIPT_OK" in r.stdout
    assert "AddressSanitizer" not in r.stderr
    assert "runtime error" not in r.stderr  # UBSan
