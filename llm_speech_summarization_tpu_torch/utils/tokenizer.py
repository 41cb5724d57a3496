"""Tokenizer abstraction.

The reference pulls HF slow tokenizers over the network
(reference: trainer.py:50-55, inference.py:32-37). This environment has no
egress, so the framework defines a minimal uniform interface with two
implementations:

  * ``HFTokenizer`` — wraps a locally available ``transformers`` tokenizer
    (from a local path / cache) for production parity.
  * ``ByteTokenizer`` — deterministic byte-level tokenizer with BOS/EOS
    special tokens, used by tests, synthetic training, and benchmarks. It
    preserves the conventions the splicing layer relies on: ``encode``
    prepends BOS exactly like HF Llama tokenizers, so the BOS-strip ``[1:]``
    convention (reference: utils.py:42-43,70-71; trainer.py:155-156;
    inference.py:117) is exercised identically.
"""

from __future__ import annotations

from typing import List, Optional, Protocol, Sequence


class Tokenizer(Protocol):
    vocab_size: int
    bos_id: int
    eos_id: int
    pad_id: int

    def encode(self, text: str, add_bos: bool = True) -> List[int]: ...

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str: ...


class ByteTokenizer:
    """UTF-8 byte tokenizer: ids 0..255 are bytes, then BOS/EOS/PAD.

    Round-trips arbitrary text; template special strings tokenize as their
    raw bytes, which is fine for synthetic training (the model only ever sees
    consistent id streams).
    """

    def __init__(self, vocab_size: int = 512):
        assert vocab_size >= 259, "need 256 bytes + BOS/EOS/PAD"
        self.vocab_size = vocab_size
        self.bos_id = 256
        self.eos_id = 257
        self.pad_id = 258

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [self.bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        data = bytes(i for i in ids if i < 256)
        text = data.decode("utf-8", errors="replace")
        if not skip_special_tokens:
            # surface specials readably
            out = []
            for i in ids:
                if i < 256:
                    out.append(bytes([i]).decode("utf-8", errors="replace"))
                elif i == self.bos_id:
                    out.append("<s>")
                elif i == self.eos_id:
                    out.append("</s>")
                elif i == self.pad_id:
                    out.append("<pad>")
                else:
                    out.append(f"<unk{i}>")
            return "".join(out)
        return text


class HFTokenizer:
    """Adapter over a ``transformers`` tokenizer loaded from a local path.

    Matches the reference's setup: left padding and ``pad = eos``
    (reference: trainer.py:50-55).
    """

    def __init__(self, path_or_id: str):
        from transformers import AutoTokenizer  # local import: heavy

        # local_files_only: this framework never reaches for the network —
        # tokenizers come from a local path or a pre-populated HF cache.
        self._tok = AutoTokenizer.from_pretrained(
            path_or_id, padding_side="left", local_files_only=True
        )
        if self._tok.pad_token is None:
            self._tok.pad_token = self._tok.eos_token
        self.vocab_size = len(self._tok)
        self.bos_id = self._tok.bos_token_id
        self.eos_id = self._tok.eos_token_id
        self.pad_id = self._tok.pad_token_id
        if self.bos_id is None:
            # the repo-wide BOS-strip contract (prefix ids include BOS;
            # suffix/response ids strip it — data/datasets.py, ops/splice.py)
            # silently DELETES the first content token of every sequence
            # under a BOS-less tokenizer; fail loudly instead
            raise ValueError(
                f"tokenizer {path_or_id!r} has no BOS token; this framework's "
                "BOS-strip data contract (reference: utils.py:27-73) requires "
                "one — use a Llama/MiniChat-family tokenizer"
            )

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        # encode WITHOUT special tokens and add BOS ourselves: relying on
        # add_special_tokens=True assumes it prepends exactly a BOS, but a
        # checkpoint exported with add_eos_token=True would also APPEND an
        # EOS that the loaders' BOS-only strip leaves embedded mid-sequence
        # (the KD loss would then teach early EOS)
        ids = self._tok(text, add_special_tokens=False).input_ids
        if add_bos:
            ids = [self.bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(
            list(ids),
            skip_special_tokens=skip_special_tokens,
            clean_up_tokenization_spaces=True,
        )


def load_tokenizer(llm_type: str, local_path: Optional[str] = None) -> Tokenizer:
    """Load the tokenizer for an LLM type; fall back to bytes when offline.

    ``local_path`` is an EXPLICIT operator choice: if it cannot be loaded,
    raise — silently training/serving on byte tokens because a production
    config typo'd a path is unrecoverable data corruption. Only the default
    resolution path (``llm_type`` via the local HF cache) falls back to
    ``ByteTokenizer``, which keeps every code path runnable offline.
    """
    if local_path:
        try:
            return HFTokenizer(local_path)
        except Exception as e:
            raise ValueError(
                f"tokenizer_path {local_path!r} was explicitly configured but "
                f"failed to load ({type(e).__name__}: {e}); refusing to fall "
                f"back to byte tokens"
            ) from e
    try:
        return HFTokenizer(llm_type)
    except Exception:
        return ByteTokenizer()
