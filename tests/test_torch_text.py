"""The text and OpenAI surfaces of the port's server, held against the
JAX package's on the CPU.

Both servers serve one small model (``torch_serve_http.jax_model``) with
a real HF fast tokenizer built in code and saved to one directory (as
``tests/test_serve_text.py`` builds it), each through its own package's
``TextTokenizer``.  For the same bodies the port's replies equal the
reference's field by field (``id``, ``created``, ``request_id`` and
``traceparent`` aside; logprobs within 1e-4): text against token
prompts, the tokenizer's EOS default, NDJSON text deltas, beam and embed
with text, the error paths and the tokenizer-less 400, ``/v1/info``'s
tokenizer, ``/v1/completions`` (greedy, a stop string, n choices, SSE
against non-streamed, the stream refusals) and
``/v1/chat/completions``.  ``StreamDecoder`` is held against the
reference's on multi-byte splits with a byte-table stand-in.
"""

import json
import urllib.request

import numpy as np
import pytest

from oim_tpu.serve import Engine as JaxEngine
from oim_tpu.serve.server import ServeServer as JaxServer
from oim_tpu.serve.texttok import StreamDecoder as JaxStreamDecoder
from oim_tpu.serve.texttok import TextTokenizer as JaxTextTokenizer

from oim_tpu_torch.serve.engine import Engine
from oim_tpu_torch.serve.server import ServeServer
from oim_tpu_torch.serve.texttok import StreamDecoder, TextTokenizer
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_serve_http import LOGPROB_ATOL, call, jax_model, url

ENGINE = dict(n_slots=2, max_len=64, chunk=4, prompt_buckets=(8, 16, 32))
IGNORED = {"id", "created", "request_id", "traceparent"}


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    """A saved HF fast tokenizer: one token a letter or space (ids under
    the model's vocabulary of 101), an EOS, and a chat template that
    joins the messages' contents."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    letters = "abcdefghijklmnopqrstuvwxyz "
    vocab = {ch: i for i, ch in enumerate(letters)}
    vocab["</s>"] = len(vocab)
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[]))
    tok.pre_tokenizer = pre_tokenizers.Split("", "isolated")
    tok.decoder = decoders.Fuse()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="</s>")
    fast.chat_template = (
        "{% for m in messages %}{{ m['content'] }}{% endfor %}")
    out = tmp_path_factory.mktemp("tok")
    fast.save_pretrained(str(out))
    return str(out)


@pytest.fixture(scope="module")
def servers(tokenizer_dir):
    """{"jax": JAX server, "port": port server}, one model and one
    tokenizer directory."""
    jcfg, jparams, tcfg, params = jax_model()
    out = {
        "jax": JaxServer(JaxEngine(jparams, jcfg, **ENGINE),
                         tokenizer=JaxTextTokenizer(tokenizer_dir)).start(),
        "port": ServeServer(Engine(params, tcfg, **ENGINE, device="cpu"),
                            tokenizer=TextTokenizer(tokenizer_dir)).start(),
    }
    yield out
    for server in out.values():
        server.stop()


def _both(servers, path, body):
    """(port (status, reply), JAX (status, reply)) of one body."""
    got = call(url(servers["port"]), path, body)
    want = call(url(servers["jax"]), path, body)
    return (got[0], got[2]), (want[0], want[2])


def _assert_same(got, want, path="") -> None:
    """Equal JSON, field by field: the run-specific fields aside,
    logprobs and embeddings within 1e-4."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert set(got) - IGNORED == set(want) - IGNORED, path
        for key in set(want) - IGNORED:
            _assert_same(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, list) and want and isinstance(want[0], float):
        np.testing.assert_allclose(got, want, atol=LOGPROB_ATOL, rtol=0,
                                   err_msg=path)
    elif isinstance(want, float):
        assert abs(got - want) <= LOGPROB_ATOL, path
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


def _same_call(servers, path, body, status=200):
    got, want = _both(servers, path, body)
    assert got[0] == want[0] == status, (got, want)
    _assert_same(got[1], want[1])
    return got[1]


def _lines(base, path, body) -> list:
    """The body lines of a streamed reply: NDJSON objects, or the SSE
    events' ``data`` payloads (``[DONE]`` as the string)."""
    req = urllib.request.Request(base + path, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    out = []
    with urllib.request.urlopen(req, timeout=60) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: "):
                payload = line[len("data: "):]
                out.append(payload if payload == "[DONE]"
                           else json.loads(payload))
            elif line:
                out.append(json.loads(line))
    return out


def test_tokenizer_matches_the_reference(tokenizer_dir):
    tok, ref = TextTokenizer(tokenizer_dir), JaxTextTokenizer(tokenizer_dir)
    ids = tok.encode("hello world")
    assert ids == ref.encode("hello world") and tok.decode(ids) == \
        "hello world"
    assert tok.eos_id == ref.eos_id is not None
    messages = [{"role": "user", "content": "ab"}]
    assert tok.apply_chat_template(messages) == ref.apply_chat_template(
        messages)


def test_text_request_equals_token_request(servers):
    tok = servers["port"].tokenizer
    text = "the quick brown fox"
    by_text = _same_call(servers, "/v1/generate",
                         {"text": text, "max_new_tokens": 5, "eos_id": -1,
                          "logprobs": True})
    by_ids = _same_call(servers, "/v1/generate",
                        {"tokens": tok.encode(text), "max_new_tokens": 5,
                         "eos_id": -1})
    assert by_text["tokens"] == by_ids["tokens"]
    assert by_text["text"] == tok.decode(by_text["tokens"])


def test_text_defaults_eos_to_tokenizer(servers, monkeypatch):
    """A text request's EOS is the tokenizer's: with an EOS that is the
    second greedy token, both servers stop there; an explicit eos_id
    wins."""
    body = {"text": "abc", "max_new_tokens": 6}
    first = _same_call(servers, "/v1/generate", dict(body, eos_id=-1))
    eos = first["tokens"][1]
    for server in servers.values():
        monkeypatch.setattr(type(server.tokenizer), "eos_id",
                            property(lambda self: eos))
    stopped = _same_call(servers, "/v1/generate", body)
    assert stopped["tokens"] == first["tokens"][:2]
    assert _same_call(servers, "/v1/generate", dict(body, eos_id=-1))[
        "tokens"] == first["tokens"]


def test_streaming_text_deltas_concatenate(servers):
    body = {"text": "abab", "max_new_tokens": 6, "stream": True,
            "eos_id": -1}
    got = _lines(url(servers["port"]), "/v1/generate", body)
    want = _lines(url(servers["jax"]), "/v1/generate", body)
    _assert_same(got, want)
    final = got[-1]
    assert final["done"]
    text = "".join(line["text"] for line in got[:-1]) + final.get("text", "")
    assert text == servers["port"].tokenizer.decode(final["tokens"])


class _ByteTok:
    """Byte-table tokenizer double: id → raw bytes, decoded with
    errors='replace' like a byte-fallback tokenizer."""

    def __init__(self, table):
        self.table = table

    def decode(self, ids):
        return b"".join(self.table[i] for i in ids).decode(
            "utf-8", errors="replace")


SQRT = "√".encode()  # e2 88 9a


@pytest.mark.parametrize("table, ids, full", [
    ({0: SQRT[:1], 1: SQRT[1:2], 2: SQRT[2:], 3: b"b"}, [0, 1, 2, 3], "√b"),
    ({0: b"a", 1: b"\xff"}, [0, 1, 1, 1, 1], "a����"),
    ({0: b"\xe2", 1: b"\xff", 2: b"c"}, [0, 1, 2], "��c"),
], ids=["split_three_ways", "legit_replacements", "tail_then_invalid"])
def test_stream_decoder_matches_the_reference(table, ids, full):
    """Multi-byte characters split across tokens: the same deltas as
    the reference's decoder, no tentative U+FFFD leaked, genuine ones
    streamed, and the deltas joined equal to the whole decode."""
    runs = []
    for decoder in (StreamDecoder, JaxStreamDecoder):
        dec = decoder(_ByteTok(table))
        deltas = [dec.push(t) for t in ids]
        runs.append((deltas, dec.flush()))
    assert runs[0] == runs[1]
    deltas, tail = runs[0]
    assert "".join(deltas) + tail == full
    if ids == [0, 1, 2, 3]:
        assert "�" not in "".join(deltas)


def test_beam_and_embed_accept_text(servers):
    tok = servers["port"].tokenizer
    beam = _same_call(servers, "/v1/beam",
                      {"text": "abc", "max_new_tokens": 3, "beam_size": 2,
                       "eos_id": -1})
    assert beam["text"] == tok.decode(beam["tokens"])
    by_text = _same_call(servers, "/v1/embed", {"text": "abc abc"})
    by_ids = _same_call(servers, "/v1/embed",
                        {"tokens": tok.encode("abc abc")})
    assert by_text["embedding"] == by_ids["embedding"]


def test_text_error_paths(servers):
    reply = _same_call(servers, "/v1/generate",
                       {"text": "a", "tokens": [1]}, status=400)
    assert "not both" in reply["error"]


def test_text_without_tokenizer_is_a_clear_400():
    jcfg, jparams, tcfg, params = jax_model()
    servers = {
        "jax": JaxServer(JaxEngine(jparams, jcfg, n_slots=1, max_len=32,
                                   chunk=4)).start(),
        "port": ServeServer(Engine(params, tcfg, n_slots=1, max_len=32,
                                   chunk=4, device="cpu")).start(),
    }
    try:
        reply = _same_call(servers, "/v1/generate",
                           {"text": "a", "max_new_tokens": 2}, status=400)
        assert "tokenizer" in reply["error"]
        for path, body in (("/v1/completions", {"prompt": "ab"}),
                           ("/v1/chat/completions", {"messages": [
                               {"role": "user", "content": "a"}]}),
                           ("/v1/completions", {"prompt": [1, 2],
                                                "stop": "x"}),
                           ("/v1/completions", {"prompt": [1, 2],
                                                "stream": True})):
            _same_call(servers, path, body, status=400)
        # Token-list prompts work without one: choices carry the tokens.
        _same_call(servers, "/v1/completions",
                   {"prompt": [1, 2, 3], "max_tokens": 3,
                    "temperature": 0.0})
        for server in servers.values():
            status, _, info = call(url(server), "/v1/info")
            assert status == 200 and info["tokenizer"] is None
    finally:
        for server in servers.values():
            server.stop()


def test_info_reports_tokenizer(servers):
    for server in servers.values():
        _, _, info = call(url(server), "/v1/info")
        assert info["tokenizer"] == server.tokenizer.path


class TestOpenAICompletions:
    def test_shape_and_greedy_match(self, servers):
        reply = _same_call(servers, "/v1/completions",
                           {"prompt": "abab", "max_tokens": 6,
                            "temperature": 0.0})
        assert reply["object"] == "text_completion"
        (choice,) = reply["choices"]
        native = _same_call(servers, "/v1/generate",
                            {"text": "abab", "max_new_tokens": 6,
                             "eos_id": -1})
        assert native["text"].startswith(choice["text"])
        usage = reply["usage"]
        assert usage["total_tokens"] == (usage["prompt_tokens"]
                                         + usage["completion_tokens"])

    @pytest.mark.parametrize("span", [1, 2], ids=["one_token", "straddling"])
    def test_stop_string_truncates(self, servers, span):
        """The text is cut at the stop string after the request ran to
        its budget (``usage`` counts every token); a two-character stop
        straddles two tokens."""
        for prompt in ("abab", "hello world", "the quick brown fox"):
            body = {"prompt": prompt, "max_tokens": 16, "temperature": 0.0}
            full = _same_call(servers, "/v1/completions", body)
            text = full["choices"][0]["text"]
            if len(text) >= 3:  # room to cut a stop out of
                break
        assert len(text) >= 3, text
        stop = text[1:1 + span]
        cut = _same_call(servers, "/v1/completions", dict(body, stop=stop))
        (choice,) = cut["choices"]
        assert choice["text"] == text[:text.find(stop)]
        assert choice["finish_reason"] == "stop"
        assert cut["usage"] == full["usage"]

    def test_n_choices_are_seeds_in_turn(self, servers):
        """Choice i is ``/v1/generate`` with seed + i (sampled streams are
        the port's own: they cannot match the reference's threefry)."""
        base = url(servers["port"])
        body = {"prompt": "ab", "max_tokens": 4, "temperature": 0.9,
                "seed": 7, "n": 2}
        _, _, reply = call(base, "/v1/completions", body)
        assert [c["index"] for c in reply["choices"]] == [0, 1]
        _, _, want = call(url(servers["jax"]), "/v1/completions", body)
        assert reply["usage"] == want["usage"]
        for i, choice in enumerate(reply["choices"]):
            _, _, native = call(base, "/v1/generate", {
                "text": "ab", "max_new_tokens": 4, "temperature": 0.9,
                "seed": 7 + i})
            assert choice["text"] == native["text"]

    def test_sse_stream_matches_nonstream(self, servers):
        body = {"prompt": "abab", "max_tokens": 6, "temperature": 0.0}
        want = _same_call(servers, "/v1/completions", body)
        events = {name: _lines(url(server), "/v1/completions",
                               dict(body, stream=True))
                  for name, server in servers.items()}
        _assert_same(events["port"], events["jax"])
        got = events["port"]
        assert got.count("[DONE]") == 1 and got[-1] == "[DONE]"
        assert all(e["object"] == "text_completion" for e in got[:-1])
        assert "".join(e["choices"][0]["text"] for e in got[:-1]) == \
            want["choices"][0]["text"]
        assert got[-2]["choices"][0]["finish_reason"] in ("stop", "length")

    @pytest.mark.parametrize("extra", [{"stop": "x"}, {"n": 2}],
                             ids=["stop", "n"])
    def test_stream_rejects_stop_and_n(self, servers, extra):
        _same_call(servers, "/v1/completions",
                   {"prompt": "ab", "max_tokens": 2, "stream": True,
                    **extra}, status=400)


class TestOpenAIChatCompletions:
    MESSAGES = [{"role": "user", "content": "ab"},
                {"role": "assistant", "content": "ba"},
                {"role": "user", "content": "ab"}]

    def test_chat_equals_completions_on_rendered_prompt(self, servers):
        chat = _same_call(servers, "/v1/chat/completions",
                          {"messages": self.MESSAGES, "max_tokens": 6,
                           "temperature": 0.0})
        assert chat["object"] == "chat.completion"
        (choice,) = chat["choices"]
        assert choice["message"]["role"] == "assistant"
        plain = _same_call(servers, "/v1/completions",
                           {"prompt": "abbaab", "max_tokens": 6,
                            "temperature": 0.0})
        assert choice["message"]["content"] == plain["choices"][0]["text"]

    def test_chat_stream_deltas(self, servers):
        body = {"messages": self.MESSAGES[:1], "max_tokens": 6,
                "temperature": 0.0}
        want = _same_call(servers, "/v1/chat/completions", body)
        events = {name: _lines(url(server), "/v1/chat/completions",
                               dict(body, stream=True))
                  for name, server in servers.items()}
        _assert_same(events["port"], events["jax"])
        got = events["port"]
        assert got[-1] == "[DONE]"
        assert all(e["object"] == "chat.completion.chunk" for e in got[:-1])
        assert "".join(e["choices"][0]["delta"].get("content", "")
                       for e in got[:-1]) == \
            want["choices"][0]["message"]["content"]

    def test_chat_requires_messages_and_template(self, servers, monkeypatch):
        _same_call(servers, "/v1/chat/completions", {"max_tokens": 2},
                   status=400)
        for server in servers.values():
            monkeypatch.setattr(server.tokenizer._tok, "chat_template", None)
        _same_call(servers, "/v1/chat/completions",
                   {"messages": [{"role": "user", "content": "a"}],
                    "max_tokens": 2}, status=400)
