"""Kaldi-compatible log-mel filterbank features on tensors.

Port of ``metatransformer_tpu/ops/fbank.py``: the reference's
``torchaudio.compliance.kaldi.fbank`` settings (htk_compat, hanning window,
128 mel bins, no dither, 10 ms shift, no energy), computed on the device
the waveform lies on, so a served waveform never returns to the host for
its DSP:

  frame (snip_edges) -> remove DC -> preemphasis 0.97 -> hanning window
  -> zero-pad to pow2 -> |rfft|^2 -> triangular mel bank (1127*ln(1+f/700),
  low=20Hz, high=nyquist) -> ln(max(e, eps)).

:func:`fbank_np` is the numpy oracle, this package's own copy of the
reference's. The mel product runs in float64 and rounds to fp32, so no
TF32 setting of the card can round its operands: the spectrum's power
and the log would amplify that rounding.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

EPS = float(np.finfo(np.float32).eps)


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    sample_rate: int = 16000
    num_mel_bins: int = 128
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    preemphasis: float = 0.97
    remove_dc: bool = True
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0 means offset from nyquist

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000)

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000)

    @property
    def fft_size(self) -> int:
        n = 1
        while n < self.frame_length:
            n *= 2
        return n


def _mel(freq):
    return 1127.0 * np.log1p(np.asarray(freq, np.float64) / 700.0)


def mel_banks(cfg: FbankConfig) -> np.ndarray:
    """Kaldi triangular mel filterbank: [num_bins, fft_size//2 + 1]; the
    nyquist column is zero."""
    nyquist = 0.5 * cfg.sample_rate
    high = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    n_fft_bins = cfg.fft_size // 2
    fft_freqs = np.arange(n_fft_bins) * (cfg.sample_rate / cfg.fft_size)
    mel_low, mel_high = _mel(cfg.low_freq), _mel(high)
    delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)
    mel_f = _mel(fft_freqs)  # [n_fft_bins]
    banks = np.zeros((cfg.num_mel_bins, n_fft_bins + 1), np.float32)
    for i in range(cfg.num_mel_bins):
        left = mel_low + i * delta
        center = left + delta
        right = center + delta
        up = (mel_f - left) / (center - left)
        down = (right - mel_f) / (right - center)
        banks[i, :n_fft_bins] = np.maximum(0.0, np.minimum(up, down)).astype(np.float32)
    return banks


def _hanning(n: int) -> np.ndarray:
    # kaldi feature-window hanning: 0.5 - 0.5*cos(2*pi*i/(N-1))
    i = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * i / (n - 1))).astype(np.float32)


def num_frames(num_samples: int, cfg: FbankConfig) -> int:
    if num_samples < cfg.frame_length:
        return 0
    return 1 + (num_samples - cfg.frame_length) // cfg.frame_shift


def fbank_np(waveform: np.ndarray, cfg: FbankConfig = FbankConfig()) -> np.ndarray:
    """Numpy oracle. waveform: [num_samples] -> [num_frames, num_mel_bins]."""
    wav = np.asarray(waveform, np.float32)
    n = num_frames(len(wav), cfg)
    fl, fs = cfg.frame_length, cfg.frame_shift
    idx = np.arange(n)[:, None] * fs + np.arange(fl)
    frames = wav[idx].astype(np.float32)  # [n, fl]
    if cfg.remove_dc:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if cfg.preemphasis:
        prev = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - cfg.preemphasis * prev
    frames = frames * _hanning(fl)[None]
    spec = np.abs(np.fft.rfft(frames, n=cfg.fft_size, axis=1)) ** 2
    mel = spec.astype(np.float32) @ mel_banks(cfg).T
    return np.log(np.maximum(mel, EPS)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _tables(cfg: FbankConfig, device: torch.device):
    """The hanning window [fl] and the transposed mel banks [fft/2+1, bins]
    in float64 on ``device``, built once per (cfg, device). Callers must not
    write to them."""
    window = torch.from_numpy(_hanning(cfg.frame_length)).to(device)
    banks = torch.from_numpy(mel_banks(cfg).T.astype(np.float64)).to(device)
    return window, banks


def fbank(waveform: torch.Tensor, cfg: FbankConfig = FbankConfig()) -> torch.Tensor:
    """waveform [B, num_samples] -> [B, frames, mel_bins] fp32, on the
    waveform's device."""
    fl, fs = cfg.frame_length, cfg.frame_shift
    n = num_frames(waveform.shape[-1], cfg)
    frames = waveform.float().unfold(-1, fl, fs)[..., :n, :]  # [B, n, fl], a strided view
    if cfg.remove_dc:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if cfg.preemphasis:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - cfg.preemphasis * prev
    window, banks = _tables(cfg, waveform.device)
    frames = frames * window
    spec = torch.fft.rfft(frames, n=cfg.fft_size, dim=-1).abs().square()
    mel = (spec.double() @ banks).float()
    return torch.log(torch.clamp_min(mel, EPS))
