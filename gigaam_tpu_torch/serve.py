"""Batching ASR server, the Triton-ensemble equivalent, dependency-free (port
of ``gigaam_tpu/serve.py``).

The reference serves via Triton with a 3-stage ensemble: python
preprocessing -> ONNX/TRT encoder -> python postprocessing
(``triton_scripts/repos/*/config.pbtxt``).  Here the same decomposition runs
in one process around the card: host audio decode -> features + encoder
(K1 on the padded rows) + decode on the device (warmed per shape bucket) ->
host text assembly, with cross-request dynamic batching (collect up to
``max_batch`` requests within ``batch_window_ms``) like Triton's scheduler.
The batch loop, the longform handlers and the stream handlers call one
model from several threads; the model's device lock serializes their
device work (``models/model.py``).

HTTP API (stdlib only):
  GET  /health               -> {"status": "ok", "model": ...}
  POST /transcribe           -> {"text": ...[, "words": [...]]}
       body: WAV bytes (Content-Type: audio/wav) or JSON
       {"audio": [floats @16 kHz]}; query ?timestamps=1 for word times.
       Word entries are {"word", "start", "end"} (seconds, ms precision) —
       the shape types.py::Word.to_dict defines, matching the reference's
       timestamp dumps (ref tests/test_timestamps.py:15).
       Audio over 25 s is rejected (400) — use /transcribe_longform.
  POST /transcribe_longform  -> {"text": ..., "segments": [{start, end,
       text[, words]}]}; same body formats, any duration (VAD-chunked).
  POST /transcribe_stream    -> NDJSON event stream (chunked response):
       {"kind": "partial"|"committed", "text", "words"} per line, one
       final committed event at end of input.  Body: 16-bit little-endian
       PCM @ 16 kHz, sent with Transfer-Encoding: chunked (or a fixed
       Content-Length); an extension over the reference (no streaming
       story there) backed by streaming.StreamingTranscriber.
  503 {"error": "overloaded"} when the request queue (shortform), the
       longform slots, or the streaming slots are full.

Usage: python -m gigaam_tpu_torch.serve --model_name <artifact> --port 8000
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from .config import LONGFORM_THRESHOLD_SEC, SAMPLE_RATE
from .models.model import GigaAMASR
from .types import TranscriptionResult

# concurrency caps for requests that live outside the shortform batching
# queue, the JAX package's values (its stream capacity was measured on a
# TPU; chip_smoke.py measures the port's stride latency under load)
LONGFORM_SLOTS = 2
STREAM_SLOTS = 4


class ASRHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog sized for request bursts
    (the stdlib default of 5 resets connections when a batch of clients
    connects at once — observed at 32 concurrent posts)."""

    request_queue_size = 128




class _Request:
    __slots__ = ("wav", "timestamps", "event", "result", "error",
                 "abandoned")

    def __init__(self, wav: np.ndarray, timestamps: bool):
        self.wav = wav
        self.timestamps = timestamps
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None
        self.abandoned = False  # client gave up (timeout) — skip the decode


class BatchingASRServer:
    """Dynamic-batching inference loop around a GigaAMASR model."""

    def __init__(self, model: GigaAMASR, max_batch: int = 8,
                 batch_window_ms: float = 15.0, beam_size: int = 1,
                 max_queue: int = 256, bucket_seconds: int = 5,
                 longform_batch: int = 16, lm=None, lm_weight: float = 0.5,
                 token_bonus: float = 0.0):
        self.model = model
        self.max_batch = max_batch
        # server-wide (not per-request): mixed beam sizes would fragment
        # batches and multiply the warmed shapes; same for the fusion LM
        self.beam_size = beam_size
        self.lm_kw = (dict(lm=lm, lm_weight=lm_weight,
                           token_bonus=token_bonus)
                      if lm is not None else {})
        # serving pads durations to coarse buckets (default 5 s vs the
        # offline path's 1 s): each reachable shape fills positional tables
        # and, for RNNT, captures CUDA graphs at first use, while padded
        # frames are masked out, so coarse buckets trade a little device
        # work for a warmable shape set (5 shortform + 6 longform)
        self.bucket_samples = int(bucket_seconds * SAMPLE_RATE)
        self.longform_batch = longform_batch
        self.window = batch_window_ms / 1000.0
        # bounded: overload answers 503 immediately instead of growing the
        # queue without limit while clients time out anyway
        self.q: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        # longform requests run outside the batching queue; cap their
        # concurrency so a burst of hour-long posts cannot spawn unbounded
        # competing device-inference threads
        self.longform_slots = threading.BoundedSemaphore(LONGFORM_SLOTS)
        # live streams likewise: each holds a handler thread and issues
        # periodic decodes for its whole lifetime
        self.stream_slots = threading.BoundedSemaphore(STREAM_SLOTS)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _bucket_edges(self, max_seconds: float) -> List[int]:
        """Serving bucket edge durations (seconds) up to ``max_seconds``."""
        step = self.bucket_samples // SAMPLE_RATE
        top = -(-int(max_seconds) // step) * step
        return list(range(step, top + 1, step))

    def warmup(self, seconds: Optional[List[int]] = None,
               longform: bool = True) -> None:
        """Run each reachable (rows, bucket) once so first requests aren't
        slow: on the card that builds the kernels at first use, fills the
        positional tables and, for RNNT, captures the label loop's CUDA
        graphs, so no request pays for them.

        With ``seconds=None``, warms *every* reachable shape: each shortform
        bucket edge (``bucket_seconds`` .. 25 s) at ``max_batch`` rows —
        ``_start`` always pads request batches to that row count, so per
        duration bucket exactly one shape exists — and, when ``longform``,
        each longform bucket edge at ``longform_batch`` rows (VAD chunks
        aim for 22 s but a single unbroken speech region is only split
        above strict_limit_duration=30 s, so 30 s is the true segment
        cap).

        An explicit ``seconds`` list warms only those shortform durations
        (plus the longform row count for the same durations)."""
        rng = np.random.default_rng(0)
        if seconds is None:
            short = self._bucket_edges(LONGFORM_THRESHOLD_SEC)
            long = self._bucket_edges(30.0) if longform else []
        else:
            short = list(seconds)
            long = list(seconds) if longform else []
        # no stream-specific warmup needed: /transcribe_stream routes its
        # stride decodes through the shortform batching queue, so it hits
        # exactly the (max_batch rows x bucket) shapes warmed above
        for s in short:
            wav = (0.01 * rng.standard_normal(SAMPLE_RATE * s)
                   ).astype(np.float32)
            self.model._decode_batch([wav], word_timestamps=False,
                                     beam_size=self.beam_size,
                                     pad_rows_to=self.max_batch,
                                     bucket=self.bucket_samples,
                                     **self.lm_kw)
        for s in long:
            wav = (0.01 * rng.standard_normal(SAMPLE_RATE * s)
                   ).astype(np.float32)
            self.model._decode_batch([wav], word_timestamps=False,
                                     beam_size=self.beam_size,
                                     pad_rows_to=self.longform_batch,
                                     bucket=self.bucket_samples,
                                     **self.lm_kw)

    def submit(self, wav: np.ndarray, timestamps: bool,
               timeout: float = 120.0) -> _Request:
        req = _Request(wav, timestamps)
        try:
            self.q.put_nowait(req)
        except queue.Full:
            req.error = "overloaded"
            return req
        if not req.event.wait(timeout):
            req.error = "timeout"
            # the client stops waiting now: mark it so the batch loop does
            # not burn a padded device decode on a result nobody reads
            # (under sustained overload those dead decodes would otherwise
            # keep the server permanently behind)
            req.abandoned = True
        return req

    def _collect(self, first: _Request) -> List[_Request]:
        batch = [first]
        deadline = time.monotonic() + self.window
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self.q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            cur = self._start(self._collect(first))
            # pipeline under backlog: dispatch the next batch's device work
            # before blocking on this one's readback — device compute
            # overlaps host extraction and the per-dispatch round trip.
            # A lone request (empty queue) finalizes immediately, so idle
            # latency is unchanged.
            while cur is not None and not self._stop.is_set():
                try:
                    nxt_first = self.q.get_nowait()
                except queue.Empty:
                    break
                nxt = self._start(self._collect(nxt_first))
                self._finish(*cur)
                cur = nxt
            if cur is not None:
                self._finish(*cur)

    @staticmethod
    def _fail(batch: List[_Request], exc: Exception) -> None:
        """Surface an error per-request and release the waiters."""
        for r in batch:
            r.error = f"{type(exc).__name__}: {exc}"
            r.event.set()

    def _start(self, batch: List[_Request]):
        """Dispatch a batch's device work.

        Returns (batch, finalize_fn), or None when every request in the
        batch was abandoned or the dispatch itself failed (errors are
        already surfaced to the requests in that case)."""
        batch = [r for r in batch if not r.abandoned]
        if not batch:
            return None
        try:
            want_ts = any(r.timestamps for r in batch)
            # pad the device row count to max_batch: otherwise every
            # distinct request-batch size is its own shape per duration
            # bucket (for RNNT, its own CUDA graph captures; at 1 row the
            # K2 dispatch instead of K1); filler rows cost little device
            # work and are dropped before any host-side decode work
            finalize = self.model._decode_batch_submit(
                [r.wav for r in batch], word_timestamps=want_ts,
                beam_size=self.beam_size, pad_rows_to=self.max_batch,
                bucket=self.bucket_samples, **self.lm_kw)
            return batch, finalize
        except Exception as exc:  # surface per-request, keep serving
            self._fail(batch, exc)
            return None

    def _finish(self, batch: List[_Request], finalize) -> None:
        try:
            outs = finalize()
            for r, (text, words) in zip(batch, outs):
                include = r.timestamps and words is not None
                r.result = TranscriptionResult(
                    text=text, words=words if include else None).to_dict()
                r.event.set()
        except Exception as exc:
            self._fail(batch, exc)

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)


def make_handler(server: BatchingASRServer,
                 max_body_bytes: int = 256 * 1024 * 1024):
    model_name = server.model.cfg.model_name

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1: the streaming endpoint's chunked response framing is
        # invalid on an HTTP/1.0 status line (version-honoring clients
        # would read the raw chunk framing as body); every non-stream
        # response carries Content-Length, so keep-alive is safe
        protocol_version = "HTTP/1.1"
        # socket read deadline: without one a stalled client parks a
        # handler thread (and a stream slot) forever
        timeout = 600

        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, obj) -> None:
            body = json.dumps(obj, ensure_ascii=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/health":
                self._send(200, {"status": "ok", "model": model_name})
            else:
                self._send(404, {"error": "not found"})

        def _body_chunks(self, max_piece: int = 1 << 15):
            """Yield request-body pieces: chunked Transfer-Encoding or a
            fixed Content-Length read in bounded pieces."""
            te = (self.headers.get("Transfer-Encoding") or "").lower()
            if "chunked" in te:
                while True:
                    line = self.rfile.readline(1024).strip()
                    if not line:
                        return
                    size = int(line.split(b";")[0], 16)
                    if size == 0:
                        # consume optional trailers up to the blank line
                        while self.rfile.readline(1024).strip():
                            pass
                        return
                    # bounded pieces: a client-declared multi-GB chunk must
                    # not be buffered whole (the fixed-length branch and the
                    # other endpoints are capped the same way)
                    while size > 0:
                        piece = self.rfile.read(min(max_piece, size))
                        if not piece:
                            return
                        size -= len(piece)
                        yield piece
                    self.rfile.read(2)  # chunk-terminating CRLF
            else:
                remaining = int(self.headers.get("Content-Length", 0))
                while remaining > 0:
                    piece = self.rfile.read(min(max_piece, remaining))
                    if not piece:
                        return
                    remaining -= len(piece)
                    yield piece

        def _handle_stream(self):
            """Incremental transcription: s16le PCM in, NDJSON events out."""
            if not server.stream_slots.acquire(blocking=False):
                self._send(503, {"error": "overloaded"})
                return
            try:
                from .streaming import StreamingTranscriber

                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def emit(ev) -> None:
                    line = (json.dumps(ev.to_dict(), ensure_ascii=False)
                            + "\n").encode()
                    self.wfile.write(f"{len(line):X}\r\n".encode()
                                     + line + b"\r\n")
                    self.wfile.flush()

                from .types import Word

                def batched_decode(buf):
                    # route stride decodes through the dynamic-batching
                    # queue: concurrent streams (and shortform traffic)
                    # share device batches AND the already-warmed
                    # (max_batch rows x bucket) shapes
                    req = server.submit(buf, timestamps=True)
                    if req.error:
                        raise RuntimeError(f"stream decode: {req.error}")
                    return [Word(text=w["word"], start=w["start"],
                                 end=w["end"])
                            for w in req.result.get("words") or []]

                st = StreamingTranscriber(server.model,
                                          beam_size=server.beam_size,
                                          bucket_s=server.bucket_samples
                                          / SAMPLE_RATE,
                                          decode_fn=batched_decode)
                try:
                    carry = b""
                    for piece in self._body_chunks():
                        data = carry + piece
                        n = len(data) // 2 * 2
                        carry = data[n:]
                        pcm = (np.frombuffer(data[:n], "<i2")
                               .astype(np.float32) / 32768.0)
                        for ev in st.push(pcm):
                            emit(ev)
                    emit(st.flush())
                except Exception as exc:
                    # headers are already out: surface the failure as a
                    # final NDJSON event and terminate the chunked stream
                    # cleanly instead of truncating it (other endpoints
                    # return structured 400/500 JSON)
                    line = (json.dumps({
                        "kind": "error",
                        "error": f"{type(exc).__name__}: {exc}"},
                        ensure_ascii=False) + "\n").encode()
                    self.wfile.write(f"{len(line):X}\r\n".encode()
                                     + line + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, TimeoutError):
                pass  # client went away or stalled mid-stream
            finally:
                server.stream_slots.release()

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path == "/transcribe_stream":
                self._handle_stream()
                return
            if parsed.path not in ("/transcribe", "/transcribe_longform"):
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                # cap before reading: a multi-GB Content-Length would be
                # buffered whole (and expanded several-fold by json/float32)
                # before any duration check, and ThreadingHTTPServer
                # multiplies that per concurrent connection
                if length > max_body_bytes:
                    self._send(413, {
                        "error": f"body larger than {max_body_bytes} bytes"})
                    return
                body = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                if "json" in ctype:
                    payload = json.loads(body)
                    wav = np.asarray(payload["audio"], dtype=np.float32)
                else:
                    from .audio import load_wav_bytes

                    wav = load_wav_bytes(body)
            except Exception as exc:
                self._send(400, {"error": f"bad request: {exc}"})
                return
            if wav.size == 0:
                self._send(400, {"error": "empty audio"})
                return
            ts = parse_qs(parsed.query).get("timestamps", ["0"])[0] == "1"

            if parsed.path == "/transcribe_longform":
                # VAD-segmented path: runs outside the batching queue (its
                # own chunk batches already fill the device), concurrency
                # bounded by longform_slots
                if not server.longform_slots.acquire(blocking=False):
                    self._send(503, {"error": "overloaded"})
                    return
                try:
                    res = server.model.transcribe_longform(
                        wav, word_timestamps=ts,
                        fr_batch_size=server.longform_batch,
                        beam_size=server.beam_size,
                        bucket=server.bucket_samples,
                        **server.lm_kw)
                except Exception as exc:
                    self._send(500, {"error": f"{type(exc).__name__}: {exc}"})
                    return
                finally:
                    server.longform_slots.release()
                self._send(200, res.to_dict(timestamps=ts))
                return

            if wav.size > LONGFORM_THRESHOLD_SEC * SAMPLE_RATE:
                self._send(400, {
                    "error": "audio longer than 25 s; use "
                             "/transcribe_longform"})
                return
            req = server.submit(wav, ts)
            if req.error == "overloaded":
                self._send(503, {"error": "overloaded"})
            elif req.error:
                self._send(500, {"error": req.error})
            else:
                self._send(200, req.result)

    return Handler


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="GigaAM batch ASR server (PyTorch/CUDA port)")
    ap.add_argument("--model_name", required=True,
                    help="a model name, a save_model artifact or a "
                         "reference .ckpt (load_model)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--batch_window_ms", type=float, default=15.0)
    ap.add_argument("--bucket_seconds", type=int, default=5,
                    help="serving duration-bucket granularity (s); smaller "
                         "= less padded compute, more shapes to warm")
    ap.add_argument("--longform_batch", type=int, default=16,
                    help="row count for longform VAD-chunk batches")
    ap.add_argument("--warmup_seconds", type=int, nargs="*", default=None,
                    help="explicit warmup durations; omit to warm every "
                         "reachable bucket (recommended), pass no values "
                         "to skip warmup")
    ap.add_argument("--max_body_mb", type=int, default=256,
                    help="reject request bodies larger than this (413)")
    ap.add_argument("--beam_size", type=int, default=1,
                    help="beam width (1 = greedy; RNNT on-device beam / CTC prefix beam)")
    ap.add_argument("--lm", default=None,
                    help="n-gram LM npz (tools/train_lm.py) for shallow "
                         "fusion; requires --beam_size > 1")
    ap.add_argument("--lm_weight", type=float, default=0.5)
    ap.add_argument("--token_bonus", type=float, default=0.0)
    args = ap.parse_args(argv)
    if args.lm and args.beam_size <= 1:
        ap.error("--lm requires --beam_size > 1 (shallow fusion biases "
                 "beam selection; greedy has nothing to bias)")

    import gigaam_tpu_torch

    model = gigaam_tpu_torch.load_model(args.model_name, device=args.device)
    assert isinstance(model, GigaAMASR), "ASR model required"
    server = BatchingASRServer(model, args.max_batch, args.batch_window_ms,
                               beam_size=args.beam_size,
                               bucket_seconds=args.bucket_seconds,
                               longform_batch=args.longform_batch,
                               lm=args.lm, lm_weight=args.lm_weight,
                               token_bonus=args.token_bonus)
    if args.warmup_seconds is None or args.warmup_seconds:
        print(f"warming up "
              f"{args.warmup_seconds if args.warmup_seconds else 'all buckets'}...")
        server.warmup(args.warmup_seconds)
    httpd = ASRHTTPServer((args.host, args.port),
                          make_handler(server,
                                       args.max_body_mb * 1024 * 1024))
    print(f"serving {model.cfg.model_name} on http://{args.host}:{args.port}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
