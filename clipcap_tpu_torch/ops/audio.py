"""Audio ops: file loading, mono mixdown, resampling, log-mel spectrograms.

Counterpart of ``clipcap_tpu/ops/audio.py``.  Two halves:

* host (numpy, the JAX package's functions verbatim): WAV decode (stdlib
  ``wave``; soundfile when installed), channel-mean mono, a windowed-sinc
  polyphase resampler, the Slaney mel filterbank, a numpy log-mel for
  variable-length audio and the fusion input;
* device (torch): framing + rFFT + mel filterbank + log, on the tensor's
  device, inside the encoder forward.

Constants are the CLAP audio config (48 kHz, n_fft 1024, hop 480, 64 mels,
fmin 50, fmax 14000: the HTSAT frontend).
"""
from __future__ import annotations

import io
import math
import wave
from functools import lru_cache
from typing import Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor

CLAP_SAMPLE_RATE = 48_000
CLAP_N_FFT = 1024
CLAP_HOP = 480
CLAP_N_MELS = 64
CLAP_FMIN = 50.0
CLAP_FMAX = 14_000.0
CLAP_CLIP_SAMPLES = 10 * CLAP_SAMPLE_RATE  # 10-second training window


# ---------------------------------------------------------------------------
# Loading (host)
# ---------------------------------------------------------------------------


def load_audio(file: Union[str, bytes, io.BytesIO]) -> Tuple[np.ndarray, int]:
    """Load an audio file → (float32 waveform [frames, channels], rate).

    Uses soundfile when available (any format); falls back to stdlib
    ``wave`` for PCM WAV.
    """
    try:
        import soundfile as sf

        data, rate = sf.read(file, dtype="float32", always_2d=True)
        return np.asarray(data, np.float32), int(rate)
    except ImportError:
        pass

    if isinstance(file, bytes):
        file = io.BytesIO(file)
    with wave.open(file, "rb") as w:
        rate = w.getframerate()
        channels = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    return data.reshape(-1, channels), rate


def to_mono(waveform: np.ndarray) -> np.ndarray:
    """[frames, channels] → [frames] by channel mean."""
    if waveform.ndim == 1:
        return waveform
    return waveform.mean(axis=1)


# ---------------------------------------------------------------------------
# Resampling (host, polyphase windowed-sinc)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=32)
def _resample_kernel(orig: int, target: int, zeros: int = 24, beta: float = 14.77):
    """Kaiser-windowed sinc filter bank for orig→target resampling, one
    phase per output step (the torchaudio/resampy construction)."""
    g = math.gcd(orig, target)
    up, down = target // g, orig // g
    cutoff = 0.5 * min(1.0, up / down)

    kernels = []
    for phase in range(up):
        offset = phase * down / up
        frac = offset - math.floor(offset)
        t = np.arange(-zeros / (2 * cutoff), zeros / (2 * cutoff) + 1) - frac
        x = 2 * cutoff * t
        window = np.kaiser(len(t), beta)
        kern = 2 * cutoff * np.sinc(x) * window
        kernels.append(kern.astype(np.float32))
    return up, down, np.stack(kernels), int(math.floor(zeros / (2 * cutoff)))


def resample(waveform: np.ndarray, orig_rate: int, target_rate: int) -> np.ndarray:
    """Polyphase windowed-sinc resampling, [frames] → [frames'] float32."""
    if orig_rate == target_rate:
        return waveform.astype(np.float32)
    up, down, kernels, left = _resample_kernel(orig_rate, target_rate)
    n_out = int(math.ceil(len(waveform) * up / down))
    width = kernels.shape[1]
    padded = np.pad(waveform.astype(np.float32), (left, width))
    out = np.empty(n_out, dtype=np.float32)
    for phase in range(up):
        starts = ((np.arange(phase, n_out, up) * down) // up)
        if len(starts) == 0:
            continue
        idx = starts[:, None] + np.arange(width)[None, :]
        out[phase::up] = (padded[idx] * kernels[phase]).sum(axis=1)
    return out


# ---------------------------------------------------------------------------
# Log-mel spectrogram
# ---------------------------------------------------------------------------


@lru_cache(maxsize=8)
def mel_filterbank(sr: int = CLAP_SAMPLE_RATE, n_fft: int = CLAP_N_FFT,
                   n_mels: int = CLAP_N_MELS, fmin: float = CLAP_FMIN,
                   fmax: float = CLAP_FMAX) -> np.ndarray:
    """Slaney-style mel filterbank [n_mels, n_fft//2+1] (librosa-compatible,
    norm='slaney', htk=False)."""

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        # Slaney: linear below 1 kHz, log above.
        mel = f / (200.0 / 3)
        log_region = f >= 1000.0
        mel = np.where(
            log_region,
            15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
            mel,
        )
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f = m * (200.0 / 3)
        log_region = m >= 15.0
        f = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)
        return f

    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    weights = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lower = (fft_freqs - mel_pts[i]) / (mel_pts[i + 1] - mel_pts[i])
        upper = (mel_pts[i + 2] - fft_freqs) / (mel_pts[i + 2] - mel_pts[i + 1])
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
        # Slaney normalization: constant energy per band.
        weights[i] *= 2.0 / (mel_pts[i + 2] - mel_pts[i])
    return weights.astype(np.float32)


def log_mel_spectrogram(
    waveform: Tensor,  # [B, T] float32 at `sr`
    sr: int = CLAP_SAMPLE_RATE,
    n_fft: int = CLAP_N_FFT,
    hop: int = CLAP_HOP,
    n_mels: int = CLAP_N_MELS,
    fmin: float = CLAP_FMIN,
    fmax: float = CLAP_FMAX,
) -> Tensor:
    """[B, T] → [B, frames, n_mels] log-mel on the waveform's device
    (torchlibrosa-style: centred frames with reflect padding, periodic
    Hann window, power spectrogram, log10 with a 1e-10 floor, ref 1.0)."""
    pad = n_fft // 2
    x = torch.nn.functional.pad(waveform.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(1, n_fft, hop)                       # [B, frames, n_fft]
    window = torch.from_numpy(np.hanning(n_fft + 1)[:-1].astype(np.float32)).to(x.device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = spec.real.square() + spec.imag.square()
    mel = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(x.device)
    mel_spec = power @ mel.t()
    return 10.0 * torch.log10(torch.clamp_min(mel_spec, 1e-10))


def log_mel_numpy(waveform: np.ndarray, sr: int = CLAP_SAMPLE_RATE,
                  n_fft: int = CLAP_N_FFT, hop: int = CLAP_HOP,
                  n_mels: int = CLAP_N_MELS, fmin: float = CLAP_FMIN,
                  fmax: float = CLAP_FMAX) -> np.ndarray:
    """Host-side (numpy) twin of ``log_mel_spectrogram`` for variable-length
    audio (the fusion transform runs per file on the host).
    [T] → [frames, n_mels]."""
    pad = n_fft // 2
    x = np.pad(waveform.astype(np.float32), (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    spec = np.fft.rfft(x[idx] * window, axis=-1)
    power = np.square(np.abs(spec)).astype(np.float32)
    mel = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    mel_spec = power @ mel.T
    return (10.0 * np.log10(np.maximum(mel_spec, 1e-10))).astype(np.float32)


CLAP_CHUNK_FRAMES = 1 + CLAP_CLIP_SAMPLES // CLAP_HOP  # 1001 mel frames / 10 s


def _resize_bilinear_frames(mel: np.ndarray, target: int) -> np.ndarray:
    """Bilinear resize along the frame axis (align_corners=False, the
    torchvision ``Resize`` convention laion_clap's fusion shrink uses)."""
    T, F = mel.shape
    if T == target:
        return mel
    pos = (np.arange(target) + 0.5) * (T / target) - 0.5
    pos = np.clip(pos, 0, T - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, T - 1)
    frac = (pos - lo).astype(np.float32)[:, None]
    return (mel[lo] * (1.0 - frac) + mel[hi] * frac).astype(np.float32)


def build_mel_fusion(waveform: np.ndarray) -> np.ndarray:
    """Fusion input for >10 s audio (laion_clap ``get_audio_features`` with
    ``data_truncating='fusion'``): ``[4, CLAP_CHUNK_FRAMES, n_mels]``:
    channel 0 the full mel shrunk to the 10 s frame count, channels 1-3
    three 10 s chunks, each starting at the centre of a third of the
    overhang.  Audio ≤ 10 s replicates its (padded) mel into all four
    channels; the model detects that and skips the fusion branch."""
    mel = log_mel_numpy(waveform)
    T = mel.shape[0]
    C = CLAP_CHUNK_FRAMES
    if T <= C:
        if T < C:
            mel = np.pad(mel, ((0, C - T), (0, 0)))
        return np.stack([mel] * 4)
    overhang = T - C
    shrink = _resize_bilinear_frames(mel, C)
    chunks = []
    for third in range(3):
        lo = overhang * third // 3
        hi = overhang * (third + 1) // 3
        start = (lo + hi) // 2
        chunks.append(mel[start:start + C])
    return np.stack([shrink] + chunks)
