"""Two-tier configuration, mirrored field for field from ``rsp_chains_tpu.configs``.

The static ``*Config`` dataclasses fix what is elaborated (maxima, compiled-in
variants, scaling policy); they carry the same fields and defaults as the JAX
package's so that ``convert.chain_config_from_reference`` can copy one into the
other by name. They are mirrored rather than imported because importing
``rsp_chains_tpu.configs`` imports jax.

``RuntimeConfig`` is the register file. In the JAX package its fields are traced
scalars so that a register write never recompiles; here they are plain Python
``int``/``float`` values that the kernel wrappers pass by value as launch
arguments, so a register write needs no device sync and never rebuilds a
kernel.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


class MagMode(enum.IntEnum):
    """LogMagMux runtime mode register (base+0)."""

    ABS = 0
    SQR = 1
    JPL = 2
    LOG2 = 3


class CfarMode(enum.IntEnum):
    """CFAR mode register (base+6)."""

    CELL_AVERAGING = 0
    GREATEST_OF = 1
    SMALLEST_OF = 2
    CASH = 3


class CfarAlgorithm(enum.IntEnum):
    """Runtime CA/GOS select (base+5), meaningful only for GOSCA elaborations."""

    CA = 0
    GOS = 1


class CfarVariant(enum.Enum):
    """Elaboration-time CFAR variant."""

    CA = "CA"
    GOS = "GOS"
    GOSCA = "GOSCA"


class FftScaling(enum.Enum):
    """FFT output scaling policy."""

    DIV_N = "div_n"
    NONE = "none"
    SQRT_N = "sqrt_n"


class Rounding(enum.Enum):
    """Fixed-point rounding mode."""

    HALF_UP = "half_up"
    HALF_EVEN = "half_even"
    TRUNCATE = "truncate"


class EdgePolicy(enum.Enum):
    """CFAR behaviour where reference windows hang off the active range."""

    PARTIAL = "partial"
    REFLECT = "reflect"
    WRAP = "wrap"


@dataclass(frozen=True)
class FixedPointConfig:
    """Fixed-point fidelity: ``enabled`` snaps stage boundaries to the
    ``FixedPoint(width, bin_point)`` grid (``numerics.quantize``);
    ``bit_true`` runs the exact integer pipeline (``ops.bit_true``) instead."""

    enabled: bool = False
    width: int = 16
    bin_point: int = 0
    rounding: Rounding = Rounding.HALF_UP
    bit_true: bool = False

    @property
    def scale(self) -> float:
        return float(2 ** self.bin_point)

    @property
    def max_int(self) -> int:
        return 2 ** (self.width - 1) - 1

    @property
    def min_int(self) -> int:
        return -(2 ** (self.width - 1))


@dataclass(frozen=True)
class PlfgConfig:
    max_num_segments: int = 4
    max_num_different_chirps: int = 8
    max_num_repeated_chirps: int = 8
    max_chirp_ordinal_num: int = 4
    max_num_frames: int = 4
    max_num_samples_width: int = 8
    output_width_int: int = 16
    output_width_frac: int = 0

    def __post_init__(self):
        if self.max_num_segments <= 0 or self.max_num_frames <= 0:
            raise ValueError("PLFG segment and frame counts must be positive")


@dataclass(frozen=True)
class NcoConfig:
    table_size: int = 128
    table_width: int = 16
    phase_width: int = 9
    rasterized_mode: bool = False
    n_interpolation_terms: int = 0
    dither_enable: bool = False
    phase_acc_enable: bool = True
    rounding: Rounding = Rounding.HALF_UP
    quantized_lut: bool = False
    sync_rom_enable: bool = False

    @property
    def amplitude(self) -> float:
        """The output scale, 2^(table_width - 2)."""
        return float(2 ** (self.table_width - 2))


@dataclass(frozen=True)
class FftConfig:
    """FFT elaboration. ``use_mxu`` and ``matmul_precision`` select the JAX
    package's TPU formulation; they are kept so that the routing gates read
    the same fields, and have no effect on the port's arithmetic."""

    max_size: int = 1024
    runtime_size: bool = True
    min_log2_size: int = 3
    scaling: FftScaling = FftScaling.DIV_N
    expand_logic: Optional[tuple] = None
    keep_msb_or_lsb: Optional[tuple] = None
    use_mxu: bool = True
    matmul_precision: str = "highest"
    window: Optional[str] = None
    use_bit_reverse: bool = True

    def __post_init__(self):
        n = self.max_size
        if n <= 0 or n & (n - 1):
            raise ValueError("fft max_size must be a power of two")
        if 2 ** self.min_log2_size > n:
            raise ValueError("2**min_log2_size exceeds max_size")
        if (self.keep_msb_or_lsb is not None
                and len(self.keep_msb_or_lsb) != self.log2_max):
            raise ValueError("keep_msb_or_lsb must have one entry per stage "
                             f"(log2(max_size) = {self.log2_max})")

    @property
    def log2_max(self) -> int:
        return self.max_size.bit_length() - 1


@dataclass(frozen=True)
class LogMagConfig:
    data_width_log: int = 16
    bin_point_log: int = 9
    log2_lookup_width: int = 9
    use_lut_log: bool = False


@dataclass(frozen=True)
class CfarConfig:
    """CFAR elaboration. ``use_pallas`` keeps its name from the JAX package:
    True routes the elaborations the kernels carry (CA, GOS and GOSCA with
    PARTIAL edges) through the hand-written kernels, False through the plain
    PyTorch ops. ``use_rdma_halo`` routes the range-sharded tail
    (``parallel/sharded.py``) through the halo kernel ``mag_extend`` and the
    CFAR kernels' given magnitude."""

    max_ref_window: int = 64
    max_guard_window: int = 8
    max_fft_size: int = 1024
    variant: CfarVariant = CfarVariant.GOSCA
    include_cash: bool = True
    min_sub_window: int = 2
    send_cut: bool = False
    emit_noise: bool = False
    edge_policy: EdgePolicy = EdgePolicy.PARTIAL
    threshold_bin_point: int = 3
    scaler_bin_point: int = 6
    use_pallas: bool = True
    use_rdma_halo: bool = False

    def __post_init__(self):
        w = self.max_ref_window
        if w <= 0 or w & (w - 1):
            raise ValueError("max_ref_window must be a power of two")
        if self.max_guard_window < 1:
            raise ValueError("max_guard_window must be >= 1")


@dataclass(frozen=True)
class MatchedFilterConfig:
    num_taps: int = 128
    fft_size: int = 4096
    method: str = "freq"
    normalize: bool = True

    def __post_init__(self):
        if self.method not in ("freq", "overlap_save"):
            raise ValueError(f"matched-filter method {self.method!r} "
                             "(choose 'freq' or 'overlap_save')")


@dataclass(frozen=True)
class DopplerConfig:
    num_pulses: int = 256
    window: Optional[str] = "hann"
    fft_shift: bool = True
    scaling: FftScaling = FftScaling.DIV_N


def _profile(p):
    """A PLFG profile as float32: a tensor stays where it lies (a CPI's
    profile on the card is not copied to the host on a register write), any
    other array becomes numpy."""
    if p is None:
        return None
    if isinstance(p, torch.Tensor):
        return p.to(torch.float32)
    return np.asarray(p, np.float32)


@dataclass
class RuntimeConfig:
    """The runtime register file as host values (see the module docstring).

    Field names, ``make()`` keywords and validation follow the JAX package's
    ``RuntimeConfig`` (reference ``RspChainVanillaTester.scala:35-62, 96-146``).
    ``threshold_scaler`` and ``phase_offset`` are rounded to float32 on
    ``make()``, as the JAX package stores them."""

    log2_fft_size: int
    mag_mode: int
    cfar_mode: int
    cfar_algorithm: int
    ref_window_size: int
    guard_window_size: int
    sub_window_size: int
    threshold_scaler: float
    div_sum: int
    peak_grouping: int
    index_lagg: int
    index_lead: int
    log_or_linear: int
    nco_freq_word: int
    phase_offset: float
    cfar_fft_size: int
    mem_start_reading: int
    mem_run_last: int
    plfg_profile: Optional[np.ndarray | torch.Tensor] = None

    @staticmethod
    def make(
        *,
        fft_size: int = 1024,
        mag_mode: int = MagMode.JPL,
        cfar_mode: int = CfarMode.CELL_AVERAGING,
        cfar_algorithm: int = CfarAlgorithm.CA,
        ref_window_size: int = 32,
        guard_window_size: int = 4,
        sub_window_size: Optional[int] = None,
        threshold_scaler: float = 3.5,
        div_sum: Optional[int] = None,
        peak_grouping: int = 0,
        index_lagg: Optional[int] = None,
        index_lead: Optional[int] = None,
        log_or_linear: int = 1,
        nco_freq_word: int = 16,
        phase_offset: float = 0.0,
        cfar_fft_size: Optional[int] = None,
        mem_start_reading: int = 1,
        mem_run_last: int = 1,
        plfg_profile=None,
        validate_against: Optional[CfarConfig] = None,
    ) -> "RuntimeConfig":
        """Build a register file from host values, applying the reference's
        ``require(...)`` rules (``RspChainVanillaTester.scala:50-61``)."""
        if fft_size <= 0 or fft_size & (fft_size - 1):
            raise ValueError("fftSize must be a power of two")
        if cfar_fft_size is None:
            cfar_fft_size = fft_size
        elif cfar_fft_size <= 0:
            raise ValueError("cfar fftSize must be positive")
        if ref_window_size <= 0 or ref_window_size & (ref_window_size - 1):
            raise ValueError("refWindowSize must be a power of two")
        if guard_window_size <= 0:
            raise ValueError("guardWindowSize must be > 0")
        if ref_window_size <= guard_window_size:
            raise ValueError("refWindowSize must be > guardWindowSize")
        if sub_window_size is not None and sub_window_size >= ref_window_size:
            raise ValueError("subWindowSize must be < refWindowSize")
        if index_lead is not None and index_lead >= ref_window_size:
            raise ValueError("indexLead must be < refWindowSize")
        if index_lagg is not None and index_lagg >= ref_window_size:
            raise ValueError("indexLagg must be < refWindowSize")
        if validate_against is not None:
            if ref_window_size > validate_against.max_ref_window:
                raise ValueError("refWindowSize exceeds elaborated max_ref_window")
            if guard_window_size > validate_against.max_guard_window:
                raise ValueError("guardWindowSize exceeds elaborated max_guard_window")
        if div_sum is None:
            div_sum = int(math.log2(ref_window_size))
        if sub_window_size is None:
            sub_window_size = max(2, ref_window_size // 4)
        if index_lagg is None:
            index_lagg = ref_window_size // 2
        if index_lead is None:
            index_lead = ref_window_size // 2
        return RuntimeConfig(
            log2_fft_size=int(fft_size).bit_length() - 1,
            mag_mode=int(mag_mode),
            cfar_mode=int(cfar_mode),
            cfar_algorithm=int(cfar_algorithm),
            ref_window_size=int(ref_window_size),
            guard_window_size=int(guard_window_size),
            sub_window_size=int(sub_window_size),
            threshold_scaler=float(np.float32(threshold_scaler)),
            div_sum=int(div_sum),
            peak_grouping=int(peak_grouping),
            index_lagg=int(index_lagg),
            index_lead=int(index_lead),
            log_or_linear=int(log_or_linear),
            nco_freq_word=int(nco_freq_word),
            phase_offset=float(np.float32(phase_offset)),
            cfar_fft_size=int(cfar_fft_size),
            mem_start_reading=int(mem_start_reading),
            mem_run_last=int(mem_run_last),
            plfg_profile=_profile(plfg_profile),
        )

    @property
    def fft_size(self) -> int:
        return 1 << self.log2_fft_size

    def peek(self) -> dict:
        """The scalar registers keyed by ``make()`` keyword names, so that
        ``make(**peek())`` round-trips. The PLFG profile is array state and is
        left out."""
        out = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
               if f.name != "plfg_profile"}
        out["fft_size"] = 1 << out.pop("log2_fft_size")
        return out

    def merge_regs(self, validate_against: Optional[CfarConfig] = None,
                   **writes) -> "RuntimeConfig":
        """Write only the named registers; the others, and the PLFG profile
        unless it is named, keep their values. Unknown names raise."""
        regs = self.peek()
        prof = writes.pop("plfg_profile", self.plfg_profile)
        unknown = set(writes) - set(regs)
        if unknown:
            raise ValueError(f"unknown registers: {sorted(unknown)}")
        regs.update(writes)
        return RuntimeConfig.make(validate_against=validate_against,
                                  plfg_profile=prof, **regs)


@dataclass(frozen=True)
class ChainConfig:
    """Top-level static bundle."""

    plfg: PlfgConfig = field(default_factory=PlfgConfig)
    nco: NcoConfig = field(default_factory=NcoConfig)
    fft: FftConfig = field(default_factory=FftConfig)
    mag: LogMagConfig = field(default_factory=LogMagConfig)
    cfar: CfarConfig = field(default_factory=CfarConfig)
    matched_filter: Optional[MatchedFilterConfig] = None
    doppler: Optional[DopplerConfig] = None
    fixed_point: FixedPointConfig = field(default_factory=FixedPointConfig)
    compute_dtype: str = "complex64"
