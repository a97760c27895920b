"""PLFG, the piecewise-linear function generator: the chirp profile source.

The port of ``rsp_chains_tpu.ops.plfg``, copied because importing that
module imports the JAX package's configs, which import jax. The hardware
(``PLFGDspBlockMem``) emits frequency words organized frames -> chirps ->
segments from registers plus a segment-instruction RAM; here each RAM word is
an explicit ``Segment``.

A program is compiled on the host, once, into a flat float32 array of
frequency-word offsets from the start value; the NCO stage adds the runtime
start register ``RuntimeConfig.nco_freq_word``, so re-steering the chirp
writes a register and rebuilds nothing. A constant profile at start value
``s`` puts the tone at FFT bin ``s * N / (4 * nco_table_size)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..configs import PlfgConfig


@dataclass(frozen=True)
class Segment:
    """One piecewise-linear segment: ``num_samples`` outputs with a
    frequency-word slope of ``increment`` a sample (0 is a constant tone)."""

    num_samples: int
    increment: float = 0.0
    reset_to_start: bool = False  # jump back to the chirp start value first


@dataclass(frozen=True)
class PlfgProgram:
    """The PLFG register file and instruction RAM as fields: the distinct
    ``chirps`` (each a tuple of ``Segment``), their ``repeat_counts``, the
    playback order ``chirp_ordinals`` and ``num_frames``. The start value is
    the runtime register ``RuntimeConfig.nco_freq_word``."""

    chirps: tuple = (Segment(num_samples=1024, increment=0.0),)
    repeat_counts: tuple = (1,)
    chirp_ordinals: tuple = (0,)
    num_frames: int = 1

    def __post_init__(self):
        # a single Segment, or a flat tuple of Segments, is one chirp
        chirps = self.chirps
        if isinstance(chirps, Segment):
            object.__setattr__(self, "chirps", ((chirps,),))
        elif chirps and isinstance(chirps[0], Segment):
            object.__setattr__(self, "chirps", (tuple(chirps),))

    def validate(self, cfg: PlfgConfig) -> None:
        """Apply the elaboration maxima (``FixedPLFGParams``)."""
        if len(self.chirps) > cfg.max_num_different_chirps:
            raise ValueError("too many distinct chirps for elaborated maximum")
        if self.num_frames > cfg.max_num_frames:
            raise ValueError("num_frames exceeds elaborated max_num_frames")
        for segs in self.chirps:
            if len(segs) > cfg.max_num_segments:
                raise ValueError("too many segments for elaborated maximum")
            for s in segs:
                if s.num_samples > 2 ** cfg.max_num_samples_width:
                    raise ValueError("segment length exceeds elaborated maximum")
        if max(self.repeat_counts) > cfg.max_num_repeated_chirps:
            raise ValueError("repeat count exceeds elaborated maximum")
        if max(self.chirp_ordinals, default=0) >= len(self.chirps):
            raise ValueError("chirp ordinal out of range")


def chirp_profile(program: PlfgProgram, cfg: PlfgConfig | None = None) -> np.ndarray:
    """A program as a flat float32 array of frequency-word offsets from the
    start value, one a sample, all frames concatenated; validated against
    ``cfg`` when given."""
    if cfg is not None:
        program.validate(cfg)

    def one_chirp(segs: Sequence[Segment]) -> np.ndarray:
        parts = []
        level = 0.0
        for s in segs:
            if s.reset_to_start:
                level = 0.0
            ramp = level + s.increment * np.arange(s.num_samples, dtype=np.float64)
            level = level + s.increment * s.num_samples
            parts.append(ramp)
        return np.concatenate(parts) if parts else np.zeros(0)

    chirp_words = [one_chirp(c) for c in program.chirps]
    frame_parts = []
    for ordinal in program.chirp_ordinals:
        rep = program.repeat_counts[ordinal] if ordinal < len(program.repeat_counts) else 1
        frame_parts.extend([chirp_words[ordinal]] * int(rep))
    frame = np.concatenate(frame_parts) if frame_parts else np.zeros(0)
    return np.tile(frame, program.num_frames).astype(np.float32)


def compile_program(program: PlfgProgram, cfg: PlfgConfig | None,
                    frame_len: int) -> np.ndarray:
    """A program compiled to the elaborated frame length: the array that
    ``RuntimeConfig.plfg_profile`` carries into a running chain. A shorter
    sample stream is cycled to fill the frame, a longer one truncated."""
    prof = chirp_profile(program, cfg)
    if prof.size == 0:
        return np.zeros(frame_len, np.float32)
    return np.resize(prof, frame_len).astype(np.float32)


def lfm_program(
    num_samples: int,
    sweep_words: float,
    num_frames: int = 1,
    max_segment: int = 256,
) -> PlfgProgram:
    """A linear-FM chirp sweeping ``sweep_words`` frequency words over
    ``num_samples`` samples, split into segments of at most ``max_segment``
    samples whose level carries across, so the profile is one ramp."""
    inc = sweep_words / max(num_samples, 1)
    segs = []
    left = num_samples
    while left > 0:
        take = min(left, max_segment)
        segs.append(Segment(num_samples=take, increment=inc))
        left -= take
    return PlfgProgram(
        chirps=(tuple(segs),),
        repeat_counts=(1,),
        chirp_ordinals=(0,),
        num_frames=num_frames,
    )
