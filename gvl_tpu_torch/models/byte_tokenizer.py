"""Byte-level tokenizer of the QA language model (a copy of
:mod:`gvl_tpu.models.byte_tokenizer`).

Token ids 0-255 are raw UTF-8 bytes, followed by the special ids below;
``VOCAB_SIZE`` is padded to 384.
"""

from __future__ import annotations

PAD_ID = 256
BOS_ID = 257
EOS_ID = 258
VOCAB_SIZE = 384  # 256 bytes + specials, padded


class ByteTokenizer:
    """UTF-8 bytes <-> ids; specials are never produced by ``encode``."""

    pad_token_id = PAD_ID
    bos_token_id = BOS_ID
    eos_token_id = EOS_ID
    vocab_size = VOCAB_SIZE

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        data = bytes(int(i) for i in ids if int(i) < 256)
        return data.decode("utf-8", errors="replace")

    def __call__(self, text: str) -> dict:
        return {"input_ids": self.encode(text)}
