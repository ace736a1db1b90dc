"""HTTP client for the batching ASR server (``gigaam_tpu_torch.serve``;
port of ``gigaam_tpu/client.py``, numpy and the stdlib only).

The analogue of the reference's Triton client
(``triton_scripts/run_client.py:11-98``): load audio files host-side, send
them to the server, collect transcription texts.  Requests are issued
concurrently so the server's dynamic batcher can actually form batches —
the reference achieves the same by sending one flattened multi-wav batch.

Usage:
    python -m gigaam_tpu_torch.client file1.wav file2.wav --url http://host:8000
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import urllib.request
from typing import Dict, List, Optional, Sequence

import numpy as np

from .audio import load_audio
from .config import SAMPLE_RATE


def _to_s16(wav: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] -> 16-bit PCM samples (shared by WAV and stream
    bodies so both paths quantize identically)."""
    return np.clip(np.rint(np.asarray(wav, np.float32) * 32768.0),
                   -32768, 32767).astype("<i2")


def _wav_bytes(wav: np.ndarray) -> bytes:
    """float32 [-1, 1] -> in-memory 16-bit PCM WAV (~1/10 the bytes of a
    JSON float list; audio is 16-bit at the source so the round trip is
    exact for loaded files)."""
    import io
    import wave

    pcm = _to_s16(wav)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        # load_audio resampled to SAMPLE_RATE; stamping anything else would
        # make the server's header-driven resample replay at the wrong speed
        wf.setframerate(SAMPLE_RATE)
        wf.writeframes(pcm.tobytes())
    return buf.getvalue()


def _post_audio(url: str, path: str, wav: np.ndarray, timestamps: bool,
                timeout: float, as_wav: bool) -> Dict:
    endpoint = f"{url.rstrip('/')}{path}"
    if timestamps:
        endpoint += "?timestamps=1"
    if as_wav:
        body = _wav_bytes(wav)
        headers = {"Content-Type": "audio/wav"}
    else:
        body = json.dumps(
            {"audio": np.asarray(wav, np.float32).tolist()}).encode()
        headers = {"Content-Type": "application/json"}
    req = urllib.request.Request(endpoint, data=body, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def transcribe_one(
    url: str,
    wav: np.ndarray,
    timestamps: bool = False,
    timeout: float = 120.0,
    as_wav: bool = True,
) -> Dict:
    """POST one utterance (float32 @ 16 kHz) -> response dict.

    Ships 16-bit WAV bytes by default (~1/10 the JSON size; exact for
    16-bit-sourced audio); ``as_wav=False`` sends the lossless JSON float
    list for synthetic/float-precision inputs."""
    return _post_audio(url, "/transcribe", wav, timestamps, timeout,
                       as_wav=as_wav)


def transcribe_longform(
    url: str,
    wav: np.ndarray,
    timestamps: bool = False,
    timeout: float = 600.0,
) -> Dict:
    """POST arbitrary-length audio to /transcribe_longform -> segments.

    Ships compact WAV bytes (an hour of JSON floats would be ~1 GB)."""
    return _post_audio(url, "/transcribe_longform", wav, timestamps, timeout,
                       as_wav=True)


def transcribe_files(
    url: str,
    files: Sequence[str],
    timestamps: bool = False,
    concurrency: int = 8,
    timeout: float = 600.0,
) -> List[Dict]:
    """Transcribe audio files against a running server; order-preserving.

    Files longer than the 25 s shortform cap route to the longform
    endpoint automatically.  ``timeout`` applies per request, verbatim —
    size it for the longest file."""
    from .config import LONGFORM_THRESHOLD_SEC

    cap = LONGFORM_THRESHOLD_SEC * SAMPLE_RATE

    def one(f):
        # decode inside the worker: loading every file up front would hold
        # the whole corpus as float32 in RAM (an hour is ~230 MB) and
        # serialize all decoding before the first request goes out
        w = load_audio(f)
        if len(w) > cap:
            return transcribe_longform(url, w, timestamps, timeout)
        return transcribe_one(url, w, timestamps, timeout)

    with cf.ThreadPoolExecutor(max_workers=max(1, concurrency)) as pool:
        futs = [pool.submit(one, f) for f in files]
        return [f.result() for f in futs]


def transcribe_stream(
    url: str,
    wav: np.ndarray,
    chunk_s: float = 0.5,
    timeout: float = 600.0,
) -> List[Dict]:
    """POST audio to /transcribe_stream as chunked s16le PCM; returns the
    NDJSON event list ({"kind": "partial"|"committed", "text", "words"}).

    Fully duplex: a reader thread drains the server's event stream while
    the upload proceeds — reading only after the upload would deadlock on
    long streams once both directions' socket buffers fill.  If the server
    rejects mid-upload (e.g. 503 overloaded), the send loop's broken pipe
    is swallowed and the actual HTTP status is raised instead."""
    import http.client
    import threading
    from urllib.parse import urlparse as _parse

    u = _parse(url)
    conn_cls = (http.client.HTTPSConnection if u.scheme == "https"
                else http.client.HTTPConnection)
    conn = conn_cls(u.hostname, u.port, timeout=timeout)
    path = u.path.rstrip("/") + "/transcribe_stream"
    result: Dict = {}

    def read_response() -> None:
        try:
            resp = conn.getresponse()
            result["status"] = resp.status
            result["body"] = resp.read()
        except Exception as exc:  # surfaced by the caller below
            result["exc"] = exc

    try:
        conn.putrequest("POST", path)
        conn.putheader("Content-Type", "audio/l16")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        reader = threading.Thread(target=read_response, daemon=True)
        reader.start()
        pcm = _to_s16(wav).tobytes()
        step = int(chunk_s * SAMPLE_RATE) * 2
        try:
            for i in range(0, len(pcm), step):
                piece = pcm[i: i + step]
                conn.send(f"{len(piece):X}\r\n".encode() + piece + b"\r\n")
            conn.send(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass  # server closed early; its status arrives via the reader
        reader.join(timeout)
        if reader.is_alive():
            raise TimeoutError("no response within timeout")
        if "exc" in result:
            raise result["exc"]
        if result["status"] != 200:
            raise RuntimeError(f"stream failed: {result['status']} "
                               f"{result['body'][:200]!r}")
        events = []
        for line in result["body"].splitlines():
            if line.strip():
                events.append(json.loads(line))
        return events
    finally:
        conn.close()


def health(url: str, timeout: float = 10.0) -> Optional[Dict]:
    try:
        with urllib.request.urlopen(f"{url.rstrip('/')}/health",
                                    timeout=timeout) as resp:
            return json.loads(resp.read())
    except Exception:
        return None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="GigaAM ASR HTTP client")
    ap.add_argument("files", nargs="+", help="audio files to transcribe")
    ap.add_argument("--url", default="http://127.0.0.1:8000")
    ap.add_argument("--timestamps", action="store_true")
    ap.add_argument("--concurrency", type=int, default=8)
    args = ap.parse_args(argv)

    status = health(args.url)
    if status is None:
        raise SystemExit(f"server at {args.url} is not reachable")
    print(f"server ok, model: {status.get('model')}")

    results = transcribe_files(args.url, args.files, args.timestamps,
                               args.concurrency)
    for path, res in zip(args.files, results):
        print(json.dumps({"file": path, **res}, ensure_ascii=False))


if __name__ == "__main__":
    main()
