"""wordpiece_tpu_torch: the PyTorch/CUDA port of wordpiece_tpu.

WordPiece encoding with exact reference semantics (gleb-kov/wordpiece),
on an NVIDIA H100: the fast word engine's match+commit step is a CUDA
kernel written by hand for sm_90a (csrc/word_kernel.cu); segmentation,
dedupe and expansion run in the native host runtime.  Imports torch,
never jax; the JAX package wordpiece_tpu stays the reference it is
tested against.

Public surface:
    wordpiece_tpu_torch.fast.encode(text, vocab, device="cuda")
    wordpiece_tpu_torch.fast.decode(vocab, ids)
    wordpiece_tpu_torch.fast.encode_external(text_file, vocab_file, out, limit)
    wordpiece_tpu_torch.make_encoder(vocab, engine="fast", device="cuda")
    wordpiece_tpu_torch.Vocabulary / parse_vocab / read_vocab_file
"""

from .api import fast, linear, make_encoder, write_ids_file
from .core.vocab import Vocabulary, parse_vocab, read_vocab_file

__all__ = [
    "fast",
    "linear",
    "make_encoder",
    "write_ids_file",
    "Vocabulary",
    "parse_vocab",
    "read_vocab_file",
]

__version__ = "0.1.0"
