"""Text surface for the serving API: an HF-tokenizer wrapper.

The port's copy of ``oim_tpu/serve/texttok.py``.  The engine is
tokenizer-agnostic (token ids in, token ids out); ``--tokenizer-dir``
loads the model's tokenizer here, and the HTTP layer gains ``{"text":
...}`` requests, decoded-text replies and the OpenAI surfaces — the
engine never sees a string.  ``transformers`` is imported only when a
``TextTokenizer`` is built, so importing this module (every server
does) needs nothing beyond the standard library.

Incremental decoding: token-at-a-time ``decode`` is wrong for BPE
(multi-byte/multi-token characters), so streaming uses
``StreamDecoder`` — decode the full generated-so-far sequence, emit the
suffix, and hold back while the tail ends in an incomplete UTF-8
replacement char.
"""

from __future__ import annotations


class TextTokenizer:
    """Lazy wrapper over ``transformers.AutoTokenizer``.

    ``transformers`` is optional: constructing this without it raises
    an error naming the missing piece, so ``serve_main --tokenizer-dir``
    fails at start on a machine that lacks it.
    """

    def __init__(self, path: str):
        try:
            from transformers import AutoTokenizer
        except ImportError as exc:
            raise RuntimeError(
                "--tokenizer-dir needs the 'transformers' package "
                "(optional dep; the token-id API works without it)"
            ) from exc
        self.path = path
        self._tok = AutoTokenizer.from_pretrained(path)

    def encode(self, text: str) -> list[int]:
        return list(self._tok(text).input_ids)

    def decode(self, token_ids: list[int]) -> str:
        # clean_up_tokenization_spaces rewrites EARLIER text when later
        # tokens arrive (' .' → '.'), which would break the streaming
        # invariant (concatenated deltas == final decode) — so cleanup
        # is off for BOTH this and the stream path, keeping decode
        # prefix-stable.
        return self._tok.decode(
            token_ids,
            skip_special_tokens=True,
            clean_up_tokenization_spaces=False,
        )

    @property
    def eos_id(self) -> int | None:
        return self._tok.eos_token_id

    def apply_chat_template(self, messages: list[dict]) -> list[int]:
        """Render an OpenAI-style ``messages`` list through the
        tokenizer's own chat template into prompt ids (the template
        ships in tokenizer_config.json next to imported weights).
        Raises ValueError when the tokenizer carries no template — a
        silently wrong fallback format would produce degraded output
        with no diagnostic."""
        if not getattr(self._tok, "chat_template", None):
            raise ValueError(
                "this tokenizer has no chat template; use "
                "/v1/completions with a raw prompt instead"
            )
        try:
            return list(
                self._tok.apply_chat_template(
                    messages, tokenize=True, add_generation_prompt=True
                )
            )
        except ValueError:
            raise
        except Exception as exc:
            # Real templates raise jinja2.TemplateError for unknown
            # roles / malformed content; surface it as the 400-mapped
            # ValueError, not a handler-killing 500.
            raise ValueError(
                f"chat template rendering failed: {exc}"
            ) from exc

    def stream_decoder(self) -> "StreamDecoder":
        return StreamDecoder(self)


class StreamDecoder:
    """Emit text deltas as tokens arrive; concatenated deltas (plus the
    final ``flush``) equal ``decode(all_tokens)`` exactly.

    Each push re-decodes the full sequence: O(total²) over a stream,
    but total is bounded by the engine's ``max_len`` and a Rust decode
    of even 8k ids is ~100 µs — the whole stream's decode overhead is
    milliseconds against minutes of generation, and anchored suffix
    decoding would reopen the sentencepiece leading-space bugs that
    plague chunked decoders.  Cleanup-off decode (see ``decode``) makes
    the full string prefix-stable; the guard below covers any exotic
    tokenizer that rewrites anyway (deltas pause, ``flush`` trues up).
    """

    def __init__(self, tokenizer: TextTokenizer):
        self._tokenizer = tokenizer
        self._tokens: list[int] = []
        self._emitted = ""
        self._prev_full = ""

    def push(self, token: int) -> str:
        """The new text this token completes ("" while mid-character)."""
        self._tokens.append(token)
        full = self._tokenizer.decode(self._tokens)
        # An incomplete multi-byte sequence decodes to U+FFFD at the
        # tail; hold those back until the next token completes them.
        # But only the NEWEST token's U+FFFDs are tentative: an
        # incomplete tail resolves by REWRITING its U+FFFD positions
        # (the completing bytes merge into one char), never by growing
        # PAST them — so a trailing U+FFFD the previous decode had is
        # confirmed real (byte-fallback on invalid bytes) once the text
        # strictly extends beyond it, and must stream, not stall until
        # flush.  Strictness matters: a growing incomplete prefix can
        # decode to the SAME single U+FFFD ('\xe2' and '\xe2\x88' both
        # → '�'), so an unchanged decode stays tentative.
        floor = (
            len(self._prev_full)
            if (
                len(full) > len(self._prev_full)
                and full.startswith(self._prev_full)
            )
            else len(self._emitted)
        )
        self._prev_full = full
        while full.endswith("�") and len(full) > floor:
            full = full[:-1]
        if not full.startswith(self._emitted):
            # Non-prefix-stable rewrite (shouldn't happen with cleanup
            # off): hold everything; flush() emits the authoritative
            # remainder.
            return ""
        delta = full[len(self._emitted):]
        self._emitted = full
        return delta

    def flush(self) -> str:
        """Anything still held back (sequence ended mid-character)."""
        full = self._tokenizer.decode(self._tokens)
        if not full.startswith(self._emitted):
            # Rewrite fallback — BEST-EFFORT: when a non-prefix-stable
            # rewrite occurred mid-stream, emitting from the divergence
            # point means the concatenated deltas may not exactly equal
            # decode(all_tokens) (the already-emitted prefix can't be
            # unsent); the final text is right from the divergence on.
            import os as _os

            common = _os.path.commonprefix([full, self._emitted])
            delta = full[len(common):]
        else:
            delta = full[len(self._emitted):]
        self._emitted = full
        return delta
