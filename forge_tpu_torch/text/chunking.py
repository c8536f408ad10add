# Copied from forge_tpu/text/chunking.py; numpy/stdlib only, so the port imports no JAX.
"""75-token chunking with BREAK and comma backtrack.

Behavioral port of the reference's chunk builder
(backend/text_processing/classic_engine.py:150-232): prompts longer than one
CLIP window are split into 75-token chunks, each wrapped with BOS/EOS and
encoded separately, embeddings concatenated. A comma within the last 20
tokens of an overflowing chunk pulls the tail into the next chunk
(`comma_padding_backtrack`), and the literal word BREAK forces a chunk
boundary. Textual-inversion embeddings occupy token slots via negative
sentinel ids resolved by the engine.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

from .emphasis import parse_prompt_attention

CHUNK_LEN = 75


@dataclasses.dataclass
class PromptChunk:
    tokens: List[int]
    multipliers: List[float]
    fixes: List[Tuple[int, object]]  # (offset, embedding) textual-inversion splices


def tokenize_line(
    line: str,
    tokenizer,
    *,
    comma_padding_backtrack: int = 20,
    embedding_lookup: Optional[Callable[[List[int], int], Optional[tuple]]] = None,
) -> Tuple[List[PromptChunk], int]:
    """→ (chunks, token_count). Each chunk is exactly CHUNK_LEN long plus
    BOS/EOS added by the encoder."""
    parsed = parse_prompt_attention(line)

    chunks: List[PromptChunk] = []
    chunk = PromptChunk([], [], [])
    token_count = 0
    last_comma = -1

    def next_chunk(is_last=False):
        nonlocal chunk, token_count, last_comma
        if is_last:
            token_count += len(chunk.tokens)
        else:
            token_count += CHUNK_LEN
        to_add = CHUNK_LEN - len(chunk.tokens)
        if to_add > 0:
            chunk.tokens += [tokenizer.eos] * to_add
            chunk.multipliers += [1.0] * to_add
        chunks.append(chunk)
        chunk = PromptChunk([], [], [])
        last_comma = -1

    for text, weight in parsed:
        if text == "BREAK" and weight == -1.0:
            next_chunk()
            continue

        tokens = list(tokenizer.ids(text))
        position = 0
        while position < len(tokens):
            token = tokens[position]

            if token == tokenizer.comma:
                last_comma = len(chunk.tokens)
            elif (
                comma_padding_backtrack != 0
                and len(chunk.tokens) == CHUNK_LEN
                and last_comma != -1
                and len(chunk.tokens) - last_comma <= comma_padding_backtrack
            ):
                # move the tail after the last comma into the next chunk
                break_location = last_comma + 1
                reloc_tokens = chunk.tokens[break_location:]
                reloc_mults = chunk.multipliers[break_location:]
                chunk.tokens = chunk.tokens[:break_location]
                chunk.multipliers = chunk.multipliers[:break_location]
                next_chunk()
                chunk.tokens = reloc_tokens
                chunk.multipliers = reloc_mults

            if len(chunk.tokens) == CHUNK_LEN:
                next_chunk()

            embedding = None
            if embedding_lookup is not None:
                embedding = embedding_lookup(tokens, position)
            if embedding is None:
                chunk.tokens.append(token)
                chunk.multipliers.append(weight)
                position += 1
                continue

            emb_vectors, consumed = embedding
            emb_len = emb_vectors.shape[0]
            if len(chunk.tokens) + emb_len > CHUNK_LEN:
                next_chunk()
            chunk.fixes.append((len(chunk.tokens), emb_vectors))
            chunk.tokens += [0] * emb_len
            chunk.multipliers += [weight] * emb_len
            position += consumed

    if chunk.tokens or not chunks:
        next_chunk(is_last=True)

    return chunks, token_count
