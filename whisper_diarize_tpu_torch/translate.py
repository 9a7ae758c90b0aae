"""Google-Translate post-pass (unofficial gtx endpoint).

The PyTorch port's own copy of `whisper_diarize_tpu/translate.py`;
the port imports nothing of the JAX package.

Mirrors the reference crate's `src/translate.rs`:

* language normalization for the endpoint: `jw`->`jv`, `yue`->`zh-TW`, and
  target-only `nn`->`no` (`translate.rs:9-37`),
* GET `https://translate.googleapis.com/translate_a/single?client=gtx&dt=t`
  parsing `body[0][0][0]` (`translate.rs:42-62`),
* 3 retries with 200/400/800 ms backoff on 429/5xx/network errors
  (`translate.rs:47-85`),
* `translate_segments`: skip empty texts, 4 concurrent requests, per-item
  progress capped at 99 then a final 100, failures keep the original text
  (`translate.rs:96-162`),
* `regenerate_words_uniform`: whitespace tokens tile [start, end] uniformly;
  words after the first get a leading space so the formatter reconstructs
  spacing (`translate.rs:168-198`).

The HTTP function is injectable for tests/air-gapped runs.
"""

from __future__ import annotations

import json
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Callable, List, Optional, Sequence, Tuple

from .types import LabeledProgressFn, ProgressType, Segment, WordTimestamp

ENDPOINT = "https://translate.googleapis.com/translate_a/single"
CONCURRENCY = 4  # `translate.rs:126`
MAX_RETRIES = 3


class TranslateError(RuntimeError):
    pass


def normalize_google_lang(code: str, is_target: bool) -> str:
    """`translate.rs:9-37`."""
    c = code.strip()
    if c.lower() == "auto":
        return "auto"
    if c == "jw":
        return "jv"
    if c == "yue":
        return "zh-TW"
    if is_target and c == "nn":
        return "no"
    return c


def _default_http_get(url: str, params: dict) -> Tuple[int, str]:
    import requests

    r = requests.get(url, params=params, timeout=30)
    return r.status_code, r.text


def translate_text(
    text: str,
    from_lang: str,
    to_lang: str,
    http_get: Optional[Callable[[str, dict], Tuple[int, str]]] = None,
) -> str:
    """One translation request with retry/backoff (`translate.rs:40-88`)."""
    http_get = http_get or _default_http_get
    sl = normalize_google_lang(from_lang, False)
    tl = normalize_google_lang(to_lang, True)
    params = {"client": "gtx", "sl": sl, "tl": tl, "dt": "t", "q": text}

    attempt = 0
    while True:
        try:
            status, body = http_get(ENDPOINT, params)
        except Exception as e:
            if attempt >= MAX_RETRIES:
                raise TranslateError(str(e)) from e
            time.sleep((200 << attempt) / 1000.0)
            attempt += 1
            continue
        if 200 <= status < 300:
            try:
                data = json.loads(body)
                chunk = data[0][0][0]
                return chunk if isinstance(chunk, str) else ""
            except Exception as e:
                raise TranslateError(f"bad response body: {e}") from e
        if status == 429 or status >= 500:
            if attempt >= MAX_RETRIES:
                break
            time.sleep((200 << attempt) / 1000.0)
            attempt += 1
            continue
        raise TranslateError(f"translate_text HTTP error {status}: {body[:200]}")
    raise TranslateError("translate_text failed after retries")


def regenerate_words_uniform(seg: Segment) -> None:
    """`translate.rs:168-198`."""
    tokens = [t for t in seg.text.split() if t]
    if not tokens:
        seg.words = []
        return
    start = seg.start
    end = max(seg.end, start)
    dur = end - start
    n = len(tokens)
    words: List[WordTimestamp] = []
    for i, w in enumerate(tokens):
        t0 = start + dur * i / n
        t1 = start + dur * (i + 1) / n
        text = w if i == 0 else f" {w}"
        words.append(WordTimestamp(text=text, start=t0, end=t1, probability=None))
    seg.words = words


def translate_segments(
    segments: Sequence[Segment],
    from_lang: str,
    to_lang: str,
    progress: Optional[LabeledProgressFn] = None,
    http_get: Optional[Callable[[str, dict], Tuple[int, str]]] = None,
) -> None:
    """Translate segments in place with bounded concurrency
    (`translate.rs:96-162`)."""
    indices: List[int] = []
    inputs: List[str] = []
    for i, seg in enumerate(segments):
        t = seg.text.strip()
        if t:
            indices.append(i)
            inputs.append(t)
    if not inputs:
        return

    total = len(inputs)
    label = f"Translating from {from_lang} to {to_lang}"
    if progress:
        progress(0, ProgressType.TRANSLATE, label)

    out: List[Optional[str]] = [None] * total
    completed = 0
    with ThreadPoolExecutor(max_workers=CONCURRENCY) as pool:
        futures = {
            pool.submit(translate_text, txt, from_lang, to_lang, http_get): k
            for k, txt in enumerate(inputs)
        }
        for fut in as_completed(futures):
            k = futures[fut]
            try:
                out[k] = fut.result()
            except Exception:
                out[k] = None  # keep original text on failure
            completed += 1
            if progress:
                percent = int(round(completed / total * 100.0))
                progress(min(percent, 99), ProgressType.TRANSLATE, label)

    for k, maybe in enumerate(out):
        if maybe is not None:
            seg = segments[indices[k]]
            seg.text = maybe
            regenerate_words_uniform(seg)

    if progress:
        progress(100, ProgressType.TRANSLATE, "Translating complete")
