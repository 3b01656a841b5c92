"""HTTP inference service (cookietts_tpu/pipeline/server.py), on tornado.

Endpoints:
- GET  ``/``        : a minimal HTML form.
- POST ``/tts``     : synthesize. Takes the reference's field names
  (``input_text``, ``input_speaker``, ``input_use_arpabet``,
  ``input_multispeaker_mode``, ``input_target_score``,
  ``input_batch_size``, ``input_max_attempts``, ``input_max_duration_s``,
  ``input_dyna_max_duration_s``, ``input_cat_silence_s``,
  ``input_textseg_len_target``, ``input_style_mode``,
  ``input_ttm_current``) and short aliases (``text``, ``speaker``, ...),
  plus ``gate_threshold`` / ``gate_delay`` / ``denoise_strength``, as a form
  or a JSON body. Returns a WAV body with the stats JSON in the
  ``X-TTS-Stats`` header (or the stats JSON alone with ``stats_only=1``);
  the WAV is also saved to the output dir.
- GET  ``/<voice>.wav`` : a generated file from the output dir (and only
  from there).

A :class:`ModelRegistry` holds named T2S workers; the ``input_ttm_current``
(or ``model``) field picks one per request. The body of the ``/tts`` handler
is :func:`handle_tts`, a plain function, so it runs without tornado (which
is imported only inside :func:`make_app` and :func:`serve`).
"""
from __future__ import annotations

import io
import json
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

_FORM_HTML = """<!doctype html>
<title>cookietts_tpu_torch</title>
<h1>cookietts_tpu_torch TTS server</h1>
<form action="/tts" method="post">
  <textarea name="input_text" rows="8" cols="80"
    placeholder="Text to synthesize..."></textarea><br>
  Speaker(s): <input name="input_speaker" value=""><br>
  Model: <input name="input_ttm_current" value=""><br>
  Multispeaker mode:
  <select name="input_multispeaker_mode">
    <option>cycle next</option><option>cycle all</option>
    <option>random</option><option>quotes</option>
  </select><br>
  Target score: <input name="input_target_score" value="0.75">
  Batch size: <input name="input_batch_size" value="32">
  Max attempts: <input name="input_max_attempts" value="64"><br>
  Max duration (s): <input name="input_max_duration_s" value="20">
  Segment length target: <input name="input_textseg_len_target" value="120">
  Silence between segments (s): <input name="input_cat_silence_s" value="0.1"><br>
  Gate threshold: <input name="gate_threshold" value="0.5">
  Gate delay: <input name="gate_delay" value="10">
  Denoise: <input name="denoise_strength" value="0.0"><br>
  <input type="checkbox" name="input_use_arpabet" checked> Use ARPAbet<br>
  <input type="submit" value="Synthesize">
</form>"""


class ModelRegistry:
    """Named T2S workers, built on first use and switched per request.
    ``factories`` maps name -> a zero-argument callable returning a T2S, or
    an already-built T2S."""

    def __init__(self, factories: Dict[str, Any], default: str):
        if default not in factories:
            raise KeyError(f"unknown default model {default!r}")
        self._factories = dict(factories)
        self._cache: Dict[str, Any] = {}
        self.default = default
        self.current = default

    def names(self):
        return list(self._factories)

    def get(self, name: Optional[str] = None):
        name = name or self.current
        if name not in self._factories:
            raise KeyError(f"unknown model {name!r}; available: {self.names()}")
        if name not in self._cache:
            f = self._factories[name]
            self._cache[name] = f() if callable(f) else f
        self.current = name
        return self._cache[name]


def _wav_bytes(audio: np.ndarray, sr: int) -> bytes:
    """16-bit PCM mono WAV of ``audio`` in [-1, 1]."""
    from scipy.io import wavfile
    buf = io.BytesIO()
    wavfile.write(buf, sr, (np.clip(audio, -1, 1) * 32767).astype(np.int16))
    return buf.getvalue()


def _truthy(v) -> bool:
    return str(v).lower() in ("1", "true", "on", "yes")


def handle_tts(registry: ModelRegistry, get: Callable,
               output_dir: str, default_speaker: Optional[str] = None
               ) -> Tuple[Dict[str, Any], bytes]:
    """One ``/tts`` request: ``get(name, default=None)`` reads a field.
    Synthesizes with the chosen worker, writes the WAV to ``output_dir``
    (named in the stats as ``voice``) and returns (stats, WAV bytes; empty
    when there is no audio)."""
    def field(short, ref=None, default=None):
        # a cleared form box posts an empty string: treat it as absent
        v = get(short)
        if v in (None, "") and ref is not None:
            v = get(ref)
        return default if v in (None, "") else v

    text = field("text", "input_text", "")
    worker = registry.get(field("model", "input_ttm_current") or None)
    speaker = field("speaker", "input_speaker") or default_speaker or ""
    if isinstance(speaker, str):
        speaker = [s.strip() for s in speaker.split(",") if s.strip()]
    kwargs: Dict[str, Any] = dict(
        speaker=speaker,
        speaker_mode=field("multispeaker_mode", "input_multispeaker_mode",
                           "cycle next"),
        use_arpabet=_truthy(field("use_arpabet", "input_use_arpabet", "0")),
        target_score=float(field("target_score", "input_target_score", 0.75)),
        batch_size=int(field("batch_size", "input_batch_size", 32)),
        max_attempts=int(field("max_attempts", "input_max_attempts", 64)),
        style_mode=field("style_mode", "input_style_mode", "torchmoji"),
        cat_silence_s=float(field("cat_silence_s", "input_cat_silence_s", 0.0)),
        denoise_strength=float(field("denoise_strength", None, 0.0)),
    )
    v = field("max_duration_s", "input_max_duration_s")
    if v:
        kwargs["max_duration_s"] = float(v)
    v = field("dyna_max_duration_s", "input_dyna_max_duration_s")
    if v:
        # seconds-per-character decode cap
        kwargs["dyna_max_duration_s"] = float(v)
    v = field("textseg_len_target", "input_textseg_len_target")
    if v:
        kwargs["target_segment_length"] = int(v)
    v = field("gate_threshold")
    if v is not None:
        kwargs["gate_threshold"] = float(v)
    v = field("gate_delay")
    if v is not None:
        kwargs["gate_delay"] = int(v)

    result = worker.infer(text, **kwargs)
    stats = {
        "segments": result["segments"],
        "speakers": result.get("speakers", []),
        "scores": [float(s) for s in result["scores"]],
        "attempts": [int(a) for a in result.get("attempts", [])],
        "failure_rate": result.get("failure_rate", 0.0),
        "audio_seconds": result.get("audio_seconds", 0.0),
        "total_time": result.get("total_time", 0.0),
        "xrt": result.get("xrt", 0.0),
        "model": registry.current,
    }
    wav = (_wav_bytes(result["audio"], worker.sample_rate)
           if len(result["audio"]) else b"")
    if wav:
        fname = f"t2s_{int(time.time() * 1000)}.wav"
        with open(os.path.join(output_dir, fname), "wb") as f:
            f.write(wav)
        stats["voice"] = fname
    return stats, wav


def make_app(t2s=None, default_speaker: Optional[str] = None,
             registry: Optional[ModelRegistry] = None,
             output_dir: Optional[str] = None):
    """The tornado Application around a T2S worker (or a
    :class:`ModelRegistry` of them)."""
    import tornado.web

    if registry is None:
        if t2s is None:
            raise ValueError("pass t2s or registry")
        registry = ModelRegistry({"default": t2s}, "default")
    output_dir = output_dir or "t2s_output"
    os.makedirs(output_dir, exist_ok=True)

    class MainHandler(tornado.web.RequestHandler):
        def get(self):
            self.write(_FORM_HTML)

    class TTSHandler(tornado.web.RequestHandler):
        def post(self):
            if self.request.headers.get("Content-Type", "").startswith(
                    "application/json"):
                get = json.loads(self.request.body).get
            else:
                get = lambda k, d=None: self.get_body_argument(k, d)  # noqa: E731
            stats, wav = handle_tts(registry, get, output_dir, default_speaker)
            if _truthy(get("stats_only", "0")) or not wav:
                self.set_header("Content-Type", "application/json")
                self.write(json.dumps(stats))
                return
            self.set_header("Content-Type", "audio/wav")
            self.set_header("X-TTS-Stats", json.dumps(stats))
            self.write(wav)

    class VoiceHandler(tornado.web.RequestHandler):
        """A generated file, from the output dir only."""

        def get(self, voice: str):
            path = os.path.realpath(os.path.join(output_dir, voice))
            if not path.startswith(os.path.realpath(output_dir) + os.sep) \
                    or not os.path.exists(path):
                raise tornado.web.HTTPError(404)
            self.set_header("Content-Type", "audio/wav")
            with open(path, "rb") as f:
                self.write(f.read())

    return tornado.web.Application([
        (r"/", MainHandler),
        (r"/tts", TTSHandler),
        (r"/([^/]+\.wav)", VoiceHandler),
    ])


def serve(t2s=None, port: int = 5000, registry=None, output_dir=None):
    """Serve on ``port`` until the process ends."""
    import tornado.ioloop
    app = make_app(t2s, registry=registry, output_dir=output_dir)
    app.listen(port)
    print(f"cookietts_tpu_torch server on :{port}")
    tornado.ioloop.IOLoop.current().start()
