#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit, and exits non-zero when CUDA is not
   available (there is no CPU fallback);
2. builds the CUDA kernels from ``rsp_chains_tpu_torch/csrc``, one ``nvcc`` a
   source, all in parallel;
3. holds each of the thirteen kernels against its plain PyTorch version at
   the headline shape, one CPI batch of 64 channels x 256 pulses x 1024 samples:
   Kernels A and B under a CA elaboration, Kernels C and D under the default
   ``ChainConfig()`` (GOSCA + CASH) with GOS registers, Kernel E on the beat
   words of the frames quantized as the JAX bench quantizes them (x 250,
   rounded, clipped to +-32767), Kernels F and G on the same integers under
   the bit-true CA and GOSCA + CASH elaborations; and at the JAX bench's
   shapes of the 2-D family: Kernel H (``rd_ca``, and ``rd_map`` for
   ``emit='map'``) and Kernel J (``rd_2d``) on the same CPIs with the bench's
   128-tap chirp, Hann Doppler window, fftshift and DIV_N
   (``bench.py:541-563``, ``:760-790``), Kernel I (``pc_ca``) on 16 x 256
   frames of 4096 (``bench.py:565-591``). The plain GOS versions gather every
   cell's window (4.3 GB a side at this shape), so they run, and are compared
   and timed, over 8-channel chunks. Kernel B is also held at the frame
   sizes of ``B_SIZES`` (rows several a block, and tiles of 4096 cells), each
   over the whole frame, an active range inside it and its magnitude given,
   Kernel I at every size of ``PC_SIZES`` (256 ... 4096) under three
   register settings, and Kernel E at N = 256, 512 and 1024 over the wire
   points that take it;
4. drives the public entry points over register sweeps, each path with the
   launch counters set to 0 just before it and read just after, each point
   asserting the kernel (or the integer ops) it took: ``fft_mag_cfar_chain``
   for the CA elaboration at the full batch and for the default elaboration,
   the bit-true CA and bit-true GOSCA elaborations on 8-channel slices, on
   the mid-size route of Kernels F and G (``csrc/int_mid.cu``): the
   headline's samples as 8192 x 2048, 4096 x 4096, 2048 x 8192 and 1024 x
   16384 frames through the chain and directly, G also at the algorithm
   register 0, and 256 frames of each size with expanding and keepLSB
   stages, each exact and launching ``rsp_int_mid``; beyond N = 16384 on
   the split route of Kernels F and G (``csrc/int_split.cu``): the
   headline's samples as 512 x 32768, 256 x 65536 and 1 x 2^18 frames and one frame of 2^20,
   F at 512 x 32768 and G at 1 x 2^18 with expanding and keepLSB stages,
   then both integer register sweeps at N = 32768; then holds the rank
   selection where it runs two windows a warp (``pair_edges``: w 1, 2, 8,
   16, 32 at the ranks 0 and w - 1, odd frame counts) against the plain
   versions, outside the launch counts: Kernel C at 3 x 1024 and 5 x 1280,
   whole frames and an active range cut inside a tile, at the bench bar
   (exactly on integer spectra), and G's mid-size route at N = 2048 ...
   16384 and its split route at 32768 exactly, the active range ending at
   a run boundary and the square sums saturated; then
   ``rx_fft_mag_cfar_tx_chain`` for the float CA and the bit-true
   elaborations; it checks the three-tone detections of the float and
   bit-true chains; then ``range_doppler_chain`` (CA at the full batch, GOSCA
   on an 8-channel slice), ``pulse_compression_chain``, ``rx_rd_tx_chain``
   and ``rd_2d_cfar_chain`` over their register sweeps, and the detection of
   a ``chirp_with_targets`` CPI at its (Doppler, range) cell; then the
   signal sources (``source_paths``): ``rsp_chain_vanilla`` (float CA,
   Kernel B) on a CUDA profile of the headline CPI, each frame's tone
   checked at its bin, ``chain_with_mem`` on a ROM CPI of three tones and
   seeded noise (Kernel C under GOS registers, B under CA registers, no
   detection with the read gate off), ``real_rx_chain`` on real CPI
   frames (the tail at 512 cells), and the fixed-point default
   ``rsp_chain_vanilla()`` on one frame over its start words (no kernel);
   then the serving and control plane (``serving_paths``): the JAX bench's
   wire stream (16 x 256 frames of 1024 words from seed 5,
   ``bench.py:130-262``) through ``StreamingPipeline`` on Kernel E, host-fed
   through the C++ frame scanner and device-fed, the float headline stream
   on Kernel A, a ``ControlServer`` poke halfway through a stream (each CPI
   whole under one register file), ``ChainServer`` on the default
   ``ChainConfig()`` (Kernel D) with a config frame and ``mem_run_last``, a
   checkpoint resumed, ``compact_detections`` and the CLI, every output bit
   for bit against direct calls, with their times (``serving`` lines);
   then the sharded chains (``rsp_chains_tpu_torch.parallel``) on meshes of virtual
   shards of the card, with the kernel halo (``use_rdma_halo``):
   ``range_sharded_mag_cfar`` on a 1 x 4 mesh and ``make_sharded_pipeline``
   on 1 x 4 and 4 x 1 meshes against the unsharded ``fft_mag_cfar_chain``,
   the halo exchange of the 1 x 4 spectrum blocks (Kernel K,
   ``halo_exchange``) against ``exchange_halo``, ``make_sharded_rd_pipeline``
   on a 2 x 2 mesh against ``range_doppler_chain`` (CA at the full batch,
   GOSCA + CASH on an 8-channel slice), and the five legs of the JAX
   package's ``__graft_entry__.dryrun_multichip`` (``parallel/dryrun.py``);
   Kernels K and L (``mag_extend``) are held against their plain versions
   on the 1 x 4 mesh's blocks (K exact, L within 1e-6 relative). With two
   cards or more the sharded paths run once more on a mesh of distinct
   cards; with one, a line says so; then the pod pipeline (``pod_paths``,
   ``parallel/multihost.py``, ``bench.py:797-818``): two processes of this
   script (``--pod-rank``) joined by ``torch.distributed`` on gloo, each a
   time block of every CPI batch, placing only its own block: layout 1
   (cpi=2, ch=1, rng=1) on batches of 2 x 64 x 256 x 1024, Kernel A in each
   process, 8 CPIs with a register write and a checkpoint after CPI 3 and
   a restored pipeline, then 16 timed beside one process's
   ``StreamingPipeline`` on the same batches; layout 2 (cpi=2, ch=2, rng=2)
   on 2 x 8 x 256 x 1024, four virtual shards of the card a process,
   cuFFT + L + B under CA and cuFFT + L + C under GOS registers. Each
   process holds its shards against the plain chain and one frame against
   ``golden.cfar_golden``; both must report the same global count a CPI,
   the plain chain's peaks over both blocks, and ``BUILDS`` 1. With two
   cards or more layout 1 runs again with one process a card, and one
   process runs time blocks that each spread over two cards;
5. times each kernel and its plain version, and the chains, with CUDA events
   (the source paths and the NCO alone too, the NCO against its bytes);
   times Kernel B at its points (the headline, the fft_size 512 spectrum, a
   GOSCA elaboration's CA registers, the range-Doppler map, the given
   magnitude of the 1 x 4 mesh) and frame sizes, Kernel I at its frame
   sizes, Kernel E at its two wire points, Kernels A, D (also under CASH
   registers), F, G and H (``rd_ca`` and ``rd_map``) at the headline,
   Kernel J at the bench's 2-D registers and at the Doppler reach 80,
   Kernels C, D and G at the
   windows 8, 32 and 64, each also with the algorithm register at 0, where
   the CA sums take the rank selection's place (the difference is the
   selection's own time), and the split route of F and G at each of its
   sizes, and F and G at the mid-size route's four shapes (``tail_times``:
   by CUDA events, on the card alone with the host's launches queued
   ahead, and the host time a call); times the split
   route of F and G at each of its sizes through the chain too, with a
   profile of its head, body and tail launches at 512 x 32768;
   times Kernel F on its three routes over the headline's samples (N =
   1024 ... 32768) at the bench's stage flags and at seven expanding
   stages;
   times, as yardsticks used nowhere in the port, ``torch.fft.fft`` +
   ``torch.fft.ifft`` over the same 16,384 rows of 1024 (for Kernel H's
   range rows) and ``torch.fft.fft`` over the pulses of the same planes
   (for the Doppler launch); prints each range-Doppler launch's byte bound;
   prints the registers, spills and stack frames of A's, D's, E's, F's,
   G's and I's row kernels, the mid-size and split routes' kernels, B, C
   and the range-Doppler kernels (Doppler columns, range rows, 2-D
   detector) from the ``-Xptxas -v`` report; builds A's, D's, E's, F's,
   G's, I's and B's seven sources once more at 1, 2, 3 and 4 blocks an SM
   (``-DRSP_ROWS_BLOCKS``, ``-DRSP_E_BLOCKS``, ``-DRSP_B_BLOCKS``), each
   build checked against the plain versions (I at N = 4096), with its
   registers, and timed;
6. profiles the full-size kernel path, the plain path, the shrunken-size
   kernel path, the default chain's GOS path, the bit-true GOSCA chain's
   GOS path, Kernels D and G at frames of 256 and 512, the range-Doppler
   kernel path (``rd_ca``), its map
   (``rd_map``) and plain paths, the 2-D detector (``rd_2d``) and the
   range-sharded tail: device time per call of each stage and of the
   busiest device kernels, and the device memory a call allocates beyond
   its inputs; and the range-Doppler kernel paths' launch split
   (``launch_split``: the Doppler, range-row and 2-D detector launches
   apart).

``python3 chip_smoke.py --compare`` only builds the kernels and prints
``tail_times`` (F and G at the mid-size route's shapes too: an earlier
checkout runs its frame-per-block kernels there) with the split route's
per-launch profile and the launch split of ``rd_ca``, ``rd_map`` and
``rd_2d`` (both 2-D points): a copy of the script in another checkout of
the port (an earlier commit), run in the same call, times that checkout's
kernels on the same card.

Bars: for the float kernels the bench's (``bench.py:404``), max|dthr| /
max|thr| < 1e-4 and peak flips <= 1e-5 of the cells; for the wire kernel the
bench's wire bar (``bench.py:655-679``), bins equal, the threshold field
within 2 LSB and 0.05 LSB on average, peak flips <= 1e-5; for the integer
kernels and chains equality; for the complex range-Doppler map
max|dmap| / max|map| < 1e-4; the sharded paths at the float bar against the
unsharded chains. Any failed check raises. The last line is the
JSON device record; the line before it lists the kernels (the mid-size
route of F and G as two more entries, ``chain_int_mid`` and
``chain_int_gos_mid``, timed at 1024 x 16384, and the split route as two
more, ``chain_int_split`` and ``chain_int_gos_split``, timed at 512 x
32768), each with its launches on the main paths, its error, its time,
its plain version's, and its bound: the larger of its bytes over 3.35
TB/s and the least operations the function needs over the H100's rate
for their type (the FFT's 5 N log2 N a frame, two along range and one
along the pulses of each range column for the range-Doppler kernels; for
the bit-true kernels N/2 log2 N butterflies of 17 integer operations a
frame; for the rank selections, a sorted window that slides by one cell,
two binary searches a window start; the halo kernels by their bytes
alone).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time

SHAPE = (64, 256, 1024)
REL_BAR = 1e-4
FLIP_BAR = 1e-5
SEED = 0
HEADLINE = dict(fft_size=1024, ref_window_size=32, guard_window_size=4,
                threshold_scaler=3.5, div_sum=5)
# register settings of the main-path sweep, each written over HEADLINE
SWEEP = [
    ("default CA", {}),
    ("GO", dict(cfar_mode=1)),
    ("SO", dict(cfar_mode=2)),
    ("ABS", dict(mag_mode=0)),
    ("SQR", dict(mag_mode=1)),
    ("LOG2", dict(mag_mode=3, log_or_linear=0, threshold_scaler=2.0)),
    ("grouping", dict(peak_grouping=1)),
    ("w64 g8", dict(ref_window_size=64, guard_window_size=8, div_sum=6)),
    ("w2 g1", dict(ref_window_size=2, guard_window_size=1, div_sum=1)),
    ("fft_size 512", dict(fft_size=512)),
    ("cfar_fft_size 768", dict(cfar_fft_size=768)),
]
# the JAX bench's GOS registers (bench.py:600-603) over HEADLINE
GOS_REGS = dict(HEADLINE, cfar_algorithm=1, index_lagg=16, index_lead=16)
GOS_CHUNK = 8  # channels per call of a plain GOS version
# (window, guard) at which Kernels C and D and their selection are timed
SEL_WINDOWS = [(8, 4), (32, 4), (64, 8)]
# the windows of the paired rank selection's edge points (pair_edges)
PAIR_WINDOWS = (1, 2, 8, 16, 32)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
NVLINK_BYTES_PER_S = 450e9  # H100 SXM NVLink, each way
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
# H100 SXM, from the CUDA C++ Programming Guide's instruction throughput
# (compute capability 9.0) at the clock the fp32 rate implies: compares
# (fp32 and int32) issue on 64 lanes of an SM a clock against 128 fp32 FMAs
# (two operations each); int32 adds on 64 more lanes beside 64 int32
# multiply-adds on the FMA pipe
CMP_PER_S = FP32_OPS_PER_S / 4
INT_OPS_PER_S = FP32_OPS_PER_S / 2
# the bit-true butterfly's integer operations (csrc/int_front.cuh
# rsp_int_butterfly) at the bench's stage flags, no expanding and no keepLSB
# stage, after constant folding: the four wrapping sums and differences with
# the RoundHalfUp +1 (one three-input add each) and their halving shifts
# (4 x 2); the sum side's unity twiddle (32768, 0), a sign extension of the
# low 17 bits a part (2); the negated twiddle sine (1); the difference
# side's two 1.15 products, each two multiply-adds (the rounding constant
# the first one's addend) and a shift (2 x 3)
INT_BUTTERFLY_OPS = 8 + 2 + 1 + 6
# the blocks an SM at which the row kernels of Kernels A, D, E, F, G and I
# and Kernel B are compared
ROW_BLOCKS = (1, 2, 3, 4)
# the card's spin while the host queues the calls ``device_ms`` times: ~60 ms
# at the H100's clock, above 30 calls of a few launches' host time
SPIN_CYCLES = 100_000_000
WIRE_LSB_MAX, WIRE_LSB_MEAN = 2, 0.05
# register settings of the default elaboration's sweep, each written over
# GOS_REGS, with the kernel each must launch; the third item is written raw,
# past make()'s rules, as a register write on a running chain can
GOS_SWEEP = [
    ("GOS CA mode", {}, {}, "chain_gos"),
    ("GOS GO", dict(cfar_mode=1), {}, "chain_gos"),
    ("GOS SO", dict(cfar_mode=2), {}, "chain_gos"),
    ("ranks 8/24", dict(index_lagg=8, index_lead=24), {}, "chain_gos"),
    ("rank 0", dict(index_lagg=0, index_lead=0), {}, "chain_gos"),
    ("rank >= window", {}, dict(index_lagg=40, index_lead=64), "chain_gos"),
    ("CASH sub_w 8", dict(cfar_mode=3, sub_window_size=8), {}, "chain_gos"),
    ("CASH sub_w 2", dict(cfar_mode=3, sub_window_size=2), {}, "chain_gos"),
    ("CASH sub_w > w", dict(cfar_mode=3, mag_mode=3, log_or_linear=0,
                            threshold_scaler=2.0), dict(sub_window_size=64),
     "chain_gos"),
    ("CA algorithm", dict(cfar_algorithm=0), {}, "chain_ca"),
    ("GOS LOG2", dict(mag_mode=3, log_or_linear=0, threshold_scaler=2.0), {},
     "chain_gos"),
    ("GOS grouping", dict(peak_grouping=1), {}, "chain_gos"),
    ("GOS w64 g8", dict(ref_window_size=64, guard_window_size=8, div_sum=6,
                        index_lagg=40, index_lead=40), {}, "chain_gos"),
    ("GOS fft_size 512", dict(fft_size=512), {}, "mag_gos_cfar"),
    ("CA fft_size 512", dict(fft_size=512, cfar_algorithm=0), {}, "mag_cfar"),
    ("CASH cfar_fft_size 768", dict(cfar_mode=3, sub_window_size=4,
                                    cfar_fft_size=768), {}, "chain_gos"),
]
# the bit-true CA elaboration's sweep over HEADLINE: (name, registers, the
# kernel it must launch, None for the integer ops); "SQR overflow" runs on
# full-scale frames, where noise * round(scaler * 64) wraps in int32
INT_SWEEP = [
    ("int CA JPL", {}, "chain_int"),
    ("int ABS", dict(mag_mode=0), "chain_int"),
    ("int SQR", dict(mag_mode=1), "chain_int"),
    ("int LUT log2", dict(mag_mode=3, log_or_linear=0, threshold_scaler=2.0),
     None),
    ("int GO", dict(cfar_mode=1), "chain_int"),
    ("int SO", dict(cfar_mode=2), "chain_int"),
    ("int log domain", dict(log_or_linear=0, threshold_scaler=8.0),
     "chain_int"),
    ("int grouping", dict(peak_grouping=1), "chain_int"),
    ("int w64 g8", dict(ref_window_size=64, guard_window_size=8, div_sum=6),
     "chain_int"),
    ("int w2 g1", dict(ref_window_size=2, guard_window_size=1, div_sum=1),
     "chain_int"),
    ("int fft_size 512", dict(fft_size=512), None),
    ("int cfar_fft_size 768", dict(cfar_fft_size=768), "chain_int"),
    ("int SQR overflow", dict(mag_mode=1, div_sum=0, threshold_scaler=64.0),
     "chain_int"),
]
# the bit-true GOSCA + CASH elaboration's sweep over GOS_REGS, as GOS_SWEEP
INT_GOS_SWEEP = [
    ("int GOS", {}, {}, "chain_int_gos"),
    ("int GOS GO", dict(cfar_mode=1), {}, "chain_int_gos"),
    ("int ranks 8/24", dict(index_lagg=8, index_lead=24), {}, "chain_int_gos"),
    ("int rank 0", dict(index_lagg=0, index_lead=0), {}, "chain_int_gos"),
    ("int rank >= window", {}, dict(index_lagg=40, index_lead=64),
     "chain_int_gos"),
    ("int CASH", dict(cfar_mode=3, sub_window_size=8), {}, None),
    ("int algorithm 0", dict(cfar_algorithm=0), {}, "chain_int"),
    ("int GOS LUT log2", dict(mag_mode=3, log_or_linear=0,
                              threshold_scaler=2.0), {}, None),
]
# Kernels F and G on the mid-size route (csrc/int_mid.cu), each on the
# headline's 16,777,216 samples as (frames, N); the points with expanding
# and keepLSB stages run on MID_FLAGGED_FRAMES frames of each N
MID_SHAPES = ((8192, 2048), (4096, 4096), (2048, 8192), (1024, 16384))
MID_FLAGGED_FRAMES = 256
# Kernels F and G beyond the mid-size route's bound (the split route,
# csrc/int_split.cu), each on the headline's 16,777,216 samples as
# (frames, N), and beyond the headline's samples one frame of 2^20 (two head
# launches); the integer register sweeps run at the first N on
# SPLIT_SWEEP_FRAMES frames
SPLIT_SHAPES = ((512, 32768), (256, 65536), (1, 1 << 18))
SPLIT_LONG = 1 << 20
SPLIT_SWEEP_FRAMES = 16
# the wire tops: (name, registers over HEADLINE, the kernel it must launch)
WIRE_SWEEP = [
    ("wire CA", {}, "wire_ca"),
    ("wire GO grouping", dict(cfar_mode=1, peak_grouping=1), "wire_ca"),
    ("wire fft_size 512", dict(fft_size=512), "mag_cfar"),
]
# the 2-D family at the JAX bench's shapes: the range-Doppler CPIs are SHAPE;
# pulse compression takes 16 x 256 frames of 4096 (bench.py:565-591) under
# its registers; the 2-D detector's elaboration and registers are the bench's
# (bench.py:771-775)
PC_SHAPE = (16, 256, 4096)
# Kernel I's frame sizes (kernels/chain.py PC_SIZES), each held and timed on
# the samples of PC_SHAPE
PC_SIZES = (256, 512, 1024, 2048, 4096)
# Kernel B's frame sizes beside the headline's 1024: rows several a block
# (128, 384 with idle threads, 1152, 4096: one a block) and tiles of 4096
# (8320: two seams and a last tile of 128 cells; 57856, the longest frame
# the earlier one-frame-a-block kernel took), each held and timed on the
# samples of SHAPE
B_SIZES = (128, 384, 1152, 4096, 8320, 57856)
PC_REGS = dict(fft_size=4096, ref_window_size=32, guard_window_size=4,
               threshold_scaler=8.0)
RD2_CFG = dict(max_ref_range=16, max_guard_range=4, max_ref_doppler=8,
               max_guard_doppler=2)
RD2_REGS = dict(ref_range=8, guard_range=2, ref_doppler=4, guard_doppler=1,
                threshold_scaler=6.0, active_range=1024)
# range_doppler_chain's sweep over HEADLINE: SWEEP without the FFT-size
# register, which the range-Doppler chain does not read
RD_SWEEP = [(name, kw) for name, kw in SWEEP if "fft_size" not in kw]
# rd_2d_cfar_chain's sweep: (name, registers over HEADLINE, 2-D registers
# over RD2_REGS); the bench's scaler finds no cell of the noise CPIs, so the
# other points take 2.5, where some cells pass
RD2_SWEEP = [
    ("2-D bench", {}, {}),
    ("2-D grouping", {}, dict(peak_grouping=1, threshold_scaler=2.5)),
    ("2-D log domain", dict(mag_mode=3), dict(log_or_linear=0,
                                              threshold_scaler=2.0)),
    ("2-D active_range 768", {}, dict(active_range=768,
                                      threshold_scaler=2.5)),
    ("2-D extents at maxima", {}, dict(ref_range=16, guard_range=4,
                                       ref_doppler=8, guard_doppler=2,
                                       threshold_scaler=2.5)),
    ("2-D extents 1/0/1/0", {}, dict(ref_range=1, guard_range=0,
                                     ref_doppler=1, guard_doppler=0,
                                     threshold_scaler=2.5)),
]
# a second 2-D elaboration whose Doppler reach (80 rows each side) spans most
# of the CPI's 256 pulses: (name, registers over HEADLINE, 2-D registers)
RD2_FAR_CFG = dict(RD2_CFG, max_ref_doppler=64, max_guard_doppler=16)
RD2_FAR_SWEEP = [
    ("2-D Doppler reach 80", {}, dict(ref_doppler=64, guard_doppler=16,
                                      threshold_scaler=2.5)),
    ("2-D Doppler reach 80 grouping", {}, dict(ref_doppler=64,
                                               guard_doppler=16,
                                               peak_grouping=1,
                                               threshold_scaler=2.5)),
]


def compare(got, want, what: str) -> float:
    """Check ``got`` against the plain ``want`` at the bar; return max|dthr|."""
    import torch

    torch.cuda.synchronize()
    if got.threshold.shape != want.threshold.shape or got.peaks.dtype != torch.bool:
        raise AssertionError(f"{what}: shape {tuple(got.threshold.shape)} / "
                             f"peaks {got.peaks.dtype}")
    if not bool(torch.isfinite(got.threshold).all()):
        raise AssertionError(f"{what}: non-finite threshold")
    dthr = (got.threshold - want.threshold).abs().max().item()
    rel = dthr / max(want.threshold.abs().max().item(), 1e-30)
    flips = int((got.peaks != want.peaks).sum().item())
    cells = want.peaks.numel()
    npk = int(want.peaks.sum().item())
    print(f"{what}: rel dthr {rel:.3e} (max|dthr| {dthr:.3e}), "
          f"peak flips {flips} of {cells} cells, {npk} peaks")
    if not (rel < REL_BAR and flips <= FLIP_BAR * cells):
        raise AssertionError(f"{what}: outside the bar")
    return dthr


def compare_map(got, want, what: str) -> float:
    """Check a complex map against the plain ``want`` at the bar; return
    max|dmap|."""
    import torch

    torch.cuda.synchronize()
    if got.re.shape != want.re.shape or not bool(
            torch.isfinite(got.re).all() & torch.isfinite(got.im).all()):
        raise AssertionError(f"{what}: shape {tuple(got.re.shape)} or "
                             "non-finite values")
    err = max((got.re - want.re).abs().max().item(),
              (got.im - want.im).abs().max().item())
    scale = max(want.re.abs().max().item(), want.im.abs().max().item())
    print(f"{what}: rel dmap {err / scale:.3e} (max|dmap| {err:.3e})")
    if not err / scale < REL_BAR:
        raise AssertionError(f"{what}: outside the bar")
    return err


def compare_exact(got, want, what: str) -> float:
    """Check the integer ``got`` equal to the plain ``want``; return
    max|dthr| (0)."""
    import torch

    torch.cuda.synchronize()
    if got.threshold.dtype != torch.int32 or got.peaks.dtype != torch.bool:
        raise AssertionError(f"{what}: threshold {got.threshold.dtype} / "
                             f"peaks {got.peaks.dtype}")
    dthr = (got.threshold.long() - want.threshold.long()).abs().max().item()
    flips = int((got.peaks != want.peaks).sum().item())
    npk = int(want.peaks.sum().item())
    print(f"{what}: max|dthr| {dthr}, peak flips {flips} of "
          f"{want.peaks.numel()} cells, {npk} peaks")
    if dthr != 0 or flips != 0:
        raise AssertionError(f"{what}: not exact")
    return float(dthr)


def compare_count(got, what: str) -> None:
    """Check the kernel's count of the peaks (``detections``) against their
    sum."""
    want = int(got.peaks.sum().item())
    if got.detections is None or int(got.detections.item()) != want:
        raise AssertionError(f"{what}: count {got.detections} against "
                             f"{want} peaks")
    print(f"{what}: the kernel counted {want} peaks, their sum")


def compare_words(got, want, bw: int, what: str) -> float:
    """Check packed CFAR words at the bench's wire bar; return the largest
    threshold-field difference in LSB."""
    import torch

    from rsp_chains_tpu_torch import packing

    torch.cuda.synchronize()
    if got.dtype != torch.int32 or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)}")
    tg, bg, pg = packing.unpack_cfar_words(got, bw)
    tw, bwant, pw = packing.unpack_cfar_words(want, bw)
    err = (tg - tw).abs().double()
    lsb_max, lsb_mean = err.max().item(), err.mean().item()
    bins = int((bg != bwant).sum().item())
    flips = int((pg != pw).sum().item())
    print(f"{what}: threshold field max|d| {lsb_max:.0f} LSB, mean "
          f"{lsb_mean:.3e} LSB, bin fields differing {bins}, peak flips "
          f"{flips} of {pw.numel()} cells, {int(pw.sum().item())} peaks")
    if not (bins == 0 and lsb_max <= WIRE_LSB_MAX
            and lsb_mean <= WIRE_LSB_MEAN and flips <= FLIP_BAR * pw.numel()):
        raise AssertionError(f"{what}: outside the wire bar")
    return lsb_max


def time_ms(fn, calls: int = 30, warm: int = 5) -> float:
    """Median ms per call over ``calls`` back-to-back calls, each bracketed by
    CUDA events, after ``warm`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def device_ms(fn, calls: int = 30) -> float:
    """Median ms a call of ``fn`` on the card alone: the card spins
    (``torch.cuda._sleep``) while the host queues ``calls`` calls, each
    bracketed by CUDA events, so no host time falls between the events."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    events = []
    for _ in range(calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def host_call_ms(fn, calls: int = 30) -> float:
    """Host ms per call of ``fn``: ``calls`` calls back to back by the host
    clock, not waiting for the card (the launches queue), after warm-up."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def ptxas_report(log: str, kernels) -> dict:
    """Registers, spill bytes (stores, loads) and stack frame bytes of each
    entry function of the ``-Xptxas -v`` report ``log`` whose mangled name
    holds one of ``kernels``, keyed by the mangled name."""
    found, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1) if any(k in m.group(1) for k in kernels) \
                else None
            spill, stack = (None, None), None
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            stack = int(m.group(1))
            spill = (int(m.group(2)), int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found[entry] = (int(m.group(1)), *spill, stack)
            entry = None
    return found


def chunked(fn, x, chunk: int = GOS_CHUNK):
    """``fn`` over the channel chunks of the frames ``x`` ([channels, ...],
    a pair or a real tensor), outputs concatenated: the plain GOS versions
    at the headline shape."""
    import torch

    from rsp_chains_tpu_torch import C, CfarOutput

    outs = [fn(x[i:i + chunk] if isinstance(x, torch.Tensor)
               else C(x.re[i:i + chunk], x.im[i:i + chunk]))
            for i in range(0, x.shape[0], chunk)]
    return CfarOutput(threshold=torch.cat([o.threshold for o in outs]),
                      peaks=torch.cat([o.peaks for o in outs]))


def profile(fn, label: str, stages, calls: int = 20, top: int = 5) -> None:
    """Print the device time per call of each stage range in ``stages`` and of
    the ``top`` busiest device kernels over ``calls`` calls of ``fn`` under
    ``torch.profiler``, and the peak device memory a call allocates."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    extra = (torch.cuda.max_memory_allocated() - base) / 2**20
    rows = prof.key_averages()
    total = sum(e.self_device_time_total for e in rows
                if e.self_cpu_time_total == 0 and e.key not in stages)
    print(f"profile [{label}]: device {total / calls / 1e3:.4f} ms a call in "
          f"kernels, {extra:.1f} MiB allocated beyond the inputs")
    for name in stages:
        us = max((e.device_time_total for e in rows if e.key == name), default=0.0)
        print(f"  stage {name}: {us / calls / 1e3:.4f} ms")
    kernels = sorted((e for e in rows if e.self_cpu_time_total == 0
                      and e.key not in stages and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    for e in kernels[:top]:
        print(f"  kernel {e.key[:70]}: {e.self_device_time_total / calls / 1e3:.4f} ms, "
              f"{e.count // calls} a call")


# the launches of the range-Doppler kernels, by their kernels' names
RD_LAUNCHES = (("Doppler", "rsp_rd_doppler_kernel"),
               ("range rows", "rsp_rd_rows_kernel"),
               ("2-D detector", "rsp_cfar2d_kernel"))


def launch_split(fn, label: str, calls: int = 20) -> dict:
    """Device ms a call of each of the range-Doppler launches (RD_LAUNCHES)
    over ``calls`` calls of ``fn`` under ``torch.profiler``; printed as one
    line and returned by launch name."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    fn()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    split = {name: sum(e.self_device_time_total for e in rows
                       if kernel in e.key) / calls / 1e3
             for name, kernel in RD_LAUNCHES}
    print(f"launch split [{label}]: " + ", ".join(
        f"{name} {ms:.4f} ms" for name, ms in split.items() if ms > 0))
    return split


def b_frame_sizes(dev, samples: int) -> dict:
    """Seeded spectra for Kernel B at each of ``B_SIZES``: samples // N
    frames of N."""
    import torch

    from rsp_chains_tpu_torch import C

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    return {n: C(*(torch.randn(samples // n, n, device=dev, generator=gen)
                   for _ in range(2))) for n in B_SIZES}


def pc_config(n: int):
    """The pulse-compression elaboration at frames of ``n``: the bench's
    128-tap matched filter and a CA CFAR (``bench.py:565-591``)."""
    import rsp_chains_tpu_torch as rsp

    return rsp.ChainConfig(
        fft=rsp.FftConfig(max_size=n),
        matched_filter=rsp.MatchedFilterConfig(num_taps=128, fft_size=n),
        cfar=rsp.CfarConfig(max_ref_window=64, max_fft_size=n,
                            variant=rsp.CfarVariant.CA, include_cash=False))


def pc_frame_sizes(dev, taps, samples: int) -> dict:
    """Kernel I's operands at each of ``PC_SIZES``: (seeded IQ frames,
    samples // N of N, their elaboration, H)."""
    import torch

    from rsp_chains_tpu_torch import C
    from rsp_chains_tpu_torch.ops.matched_filter import h_planes

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    return {n: (C(*(torch.randn(samples // n, n, device=dev, generator=gen)
                    * 100 for _ in range(2))), pc_config(n),
                h_planes(taps, n, True, dev)) for n in PC_SIZES}


def at_size(c, n: int):
    """The chain config ``c`` at frames of ``n`` (its FFT's and CFAR's
    sizes)."""
    import rsp_chains_tpu_torch as rsp

    return dataclasses.replace(c, fft=rsp.FftConfig(max_size=n),
                               cfar=dataclasses.replace(c.cfar,
                                                        max_fft_size=n))


def sel_registers(w: int, g: int):
    """GOS_REGS at the window w and guard g, divSum log2 w, ranks w / 2."""
    import rsp_chains_tpu_torch as rsp

    return rsp.RuntimeConfig.make(**{
        **GOS_REGS, "ref_window_size": w, "guard_window_size": g,
        "div_sum": w.bit_length() - 1, "index_lagg": w // 2,
        "index_lead": w // 2})


def sel_label(name: str, w: int, g: int, alg: int) -> str:
    return (f"{name} at {'x'.join(map(str, SHAPE))}, GOS registers at w {w} "
            f"g {g}, algorithm {alg}")


def mid_label(name: str, frames: int, n: int) -> str:
    """``tail_times``' label of Kernel F (``name`` chain_int) or G at
    ``frames`` x ``n``, one of MID_SHAPES."""
    regs = "GOS" if name == "chain_int_gos" else "headline"
    return f"{name} at {frames}x{n}, {regs} registers"


def pair_registers(n: int, w: int, rank: int, **kw):
    """GOS_REGS at FFT size n and window w (guard max(1, w // 8); w = 1 with
    guard 0 written past make()'s rules), the lag rank ``rank`` (0 or w - 1)
    and the lead rank its mirror, ``kw`` written over them."""
    import rsp_chains_tpu_torch as rsp

    mw = max(w, 2)
    rt = rsp.RuntimeConfig.make(**{
        **GOS_REGS, "fft_size": n, "ref_window_size": mw,
        "guard_window_size": max(1, mw // 8), "div_sum": mw.bit_length() - 1,
        "index_lagg": min(rank, mw - 1), "index_lead": min(w - 1 - rank,
                                                           mw - 1), **kw})
    if w == 1:
        rt = dataclasses.replace(rt, ref_window_size=1, guard_window_size=0,
                                 index_lagg=0, index_lead=0)
    return rt


def run_boundary(n: int, w: int, g: int) -> int:
    """The CFAR size whose first inactive cell starts the fourth run of
    window starts of the paired selection (csrc/gos_cfar.cuh): frame pairs
    over a block's rows at N = 2048 and 4096, run pairs over its one row at
    8192 and over each half-frame at 16384 (the second), run pairs over the
    split tail's tiles of 4096 (the second)."""
    if n > 16384:
        span, runs, org = 4096, 16, 4096
    elif n >= 8192:
        span, runs, org = 8192, 64, 8192 if n == 16384 else 0
    else:
        span, runs, org = n, 32 // (8192 // n // 2), 0
    per = -(-(span + 2 * g + w + 1) // runs)
    if n >= 8192:
        per |= 1
    return org + 3 * per - g - w


def pair_edges(dev, card: str) -> int:
    """Kernels C and G where the rank selection runs two windows a warp (w
    <= 32): C (frame pairs) at 3 x 1024 and 5 x 1280 (tiles of 1024 and
    256), G's mid-size route at N = 2048 ... 16384 (frame pairs, then run
    pairs) and its split route at 32768 (run pairs in the tail), each at the
    windows of PAIR_WINDOWS and the ranks 0 and w - 1, odd frame counts
    (the last block's dead half): C on Gaussian spectra at the bench bar and
    on integer spectra under SQR exactly, the whole frame and an active
    range cut inside a tile (the magnitude given); G exactly, with the
    active range ending at a run boundary and on full-scale frames through
    seven expanding stages (square sums saturated at INT32_MAX). Raises on
    any miss; returns the points checked. These calls compare the kernels
    with their plain versions; no main path runs here."""
    import torch

    import rsp_chains_tpu_torch as rsp
    from rsp_chains_tpu_torch.kernels import _build
    from rsp_chains_tpu_torch.kernels import cfar as kcfar
    from rsp_chains_tpu_torch.kernels import int_chain as kint
    from rsp_chains_tpu_torch.ops.bit_true import fft_int_op, mag_int_op
    from rsp_chains_tpu_torch.ops.logmag import logmag

    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    ccfg = rsp.CfarConfig()
    checked = 0
    for frames, n in ((3, 1024), (5, 1280)):
        gauss = rsp.C(*(torch.randn(frames, n, device=dev, generator=gen)
                        for _ in range(2)))
        ints = rsp.C(*(torch.randint(-3, 4, (frames, n), device=dev,
                                     generator=gen).float()
                       for _ in range(2)))
        ints.re[:, 40] += 25.0
        for w in PAIR_WINDOWS:
            for rank in (0, w - 1):
                for x, mag_mode in ((gauss, 2), (ints, 1)):
                    rt = dataclasses.replace(
                        pair_registers(1024, w, rank, mag_mode=mag_mode),
                        cfar_fft_size=n)
                    for cut in (False, True):
                        kw = (dict(active_lo=37, active_hi=n - 101,
                                   mag_given=True) if cut else {})
                        v = logmag(x, mag_mode) if cut else x
                        before = collections.Counter(_build.LAUNCHES)
                        got = kcfar.mag_gos_cfar(v, rt, ccfg, **kw)
                        if collections.Counter(_build.LAUNCHES) - before != \
                                collections.Counter({"mag_gos_cfar": 1}):
                            raise AssertionError(
                                f"mag_gos_cfar {frames}x{n} w {w} did not "
                                f"launch")
                        want = kcfar.mag_gos_cfar_reference(v, rt, ccfg,
                                                            **kw)
                        torch.cuda.synchronize()
                        d = (got.threshold - want.threshold).abs().max()
                        rel = d.item() / want.threshold.abs().max().item()
                        flips = int((got.peaks != want.peaks).sum().item())
                        if (mag_mode == 1 and (rel != 0 or flips)) or not (
                                rel < REL_BAR and flips <= FLIP_BAR
                                * want.peaks.numel()):
                            raise AssertionError(
                                f"mag_gos_cfar {frames}x{n} w {w} rank "
                                f"{rank} mag_mode {mag_mode} cut {cut}: rel "
                                f"dthr {rel:.3e}, {flips} flips")
                        checked += 1
    print(f"two windows a warp, mag_gos_cfar: {checked} points at 3x1024 and "
          f"5x1280, w {PAIR_WINDOWS}, ranks 0 and w - 1, whole and cut "
          f"frames, within the bench bar (exact on integer spectra); card "
          f"{card}")
    g_checked = 0
    for n, frames in ((2048, 3), (4096, 3), (8192, 3), (16384, 3),
                      (32768, 2)):
        cfg = at_size(rsp.ChainConfig(), n).cfar
        full = rsp.C(*(32767 * (2 * torch.randint(
            0, 2, (frames, n), device=dev, generator=gen,
            dtype=torch.int32) - 1) for _ in range(2)))
        rand = rsp.C(*(torch.randint(-20000, 20001, (frames, n), device=dev,
                                     generator=gen, dtype=torch.int32)
                       for _ in range(2)))
        seven = rsp.FftConfig(max_size=n, expand_logic=tuple(
            int(s < 7) for s in range(n.bit_length() - 1)))
        plain_fft = rsp.FftConfig(max_size=n)
        if not bool((mag_int_op(fft_int_op(full, None, seven), 1)
                     == 2**31 - 1).any()):
            raise AssertionError(f"N {n}: no square sum saturated")
        name = "chain_int_gos_mid" if n <= 16384 else "chain_int_gos_split"
        for w in PAIR_WINDOWS:
            g = 0 if w == 1 else max(1, w // 8)
            for rank in (0, w - 1):
                for case, x, fft_n, kw in (
                        ("cut at a run boundary", rand, plain_fft,
                         dict(cfar_fft_size=run_boundary(n, w, g))),
                        ("SQR saturated", full, seven, dict(mag_mode=1))):
                    rt = pair_registers(n, w, rank, **kw)
                    before = collections.Counter(_build.LAUNCHES)
                    got = kint.chain_int_gos(x, rt, fft_n, cfg)
                    if collections.Counter(_build.LAUNCHES) - before != \
                            collections.Counter({name: 1}):
                        raise AssertionError(f"{name} N {n} did not launch")
                    want = kint.chain_int_gos_reference(x, rt, fft_n, cfg)
                    torch.cuda.synchronize()
                    if not (torch.equal(got.threshold, want.threshold)
                            and torch.equal(got.peaks, want.peaks)):
                        raise AssertionError(
                            f"{name} {frames}x{n} w {w} rank {rank} "
                            f"[{case}]: not exact")
                    g_checked += 1
        print(f"two windows a warp, {name} at {frames}x{n}: w {PAIR_WINDOWS}, "
              f"ranks 0 and w - 1, cut at a run boundary and SQR saturated: "
              f"exact; card {card}")
    return checked + g_checked


def tail_times(dev, profiles: bool = False) -> dict:
    """Kernel B at its points and frame sizes and Kernel I at its frame
    sizes, with Kernel A at the headline beside them as a yardstick, Kernel
    E at the wire points, Kernels D, F, G and H (``rd_ca``, ``rd_map``) at
    the headline (D under GOS and CASH registers), Kernel J at the bench's
    2-D registers and at the Doppler reach 80, Kernels C, D and G at each of
    SEL_WINDOWS with the algorithm register at 1 and at 0, F and G at
    MID_SHAPES (on this checkout the mid-size route; on checkouts before it
    the frame-per-block kernels), and the split route of F and G at
    SPLIT_SHAPES; each on seeded inputs of SHAPE's
    samples: (median ms by CUDA events, on the card alone (``device_ms``),
    host ms a call). Only entry points that every version of the port since
    its sharded chains has are called (the split route's since it came),
    so ``--compare`` runs it on an earlier checkout too. With ``profiles``
    it then prints the per-launch profile (head, body, tail) of the split
    route at the first of SPLIT_SHAPES and the launch split of H and J."""
    import numpy as np
    import torch

    import rsp_chains_tpu_torch as rsp
    from rsp_chains_tpu_torch import parallel as SP
    from rsp_chains_tpu_torch.kernels import cfar as kcfar
    from rsp_chains_tpu_torch.kernels import chain as kchain
    from rsp_chains_tpu_torch.kernels import halo as khalo
    from rsp_chains_tpu_torch.kernels import int_chain as kint
    from rsp_chains_tpu_torch.kernels import rd as krd
    from rsp_chains_tpu_torch.ops.fft import fft_op

    cfg = rsp.ChainConfig(
        fft=rsp.FftConfig(max_size=SHAPE[-1]),
        cfar=rsp.CfarConfig(max_ref_window=64, variant=rsp.CfarVariant.CA,
                            include_cash=False, max_fft_size=SHAPE[-1]))
    gcfg = rsp.ChainConfig()
    rng = np.random.RandomState(SEED)
    x = rsp.as_pair(rng.randn(*SHAPE).astype(np.float32)
                    + 1j * rng.randn(*SHAPE).astype(np.float32), device=dev)
    rt = rsp.RuntimeConfig.make(**HEADLINE)
    small = rt.merge_regs(fft_size=512)
    samples = x.re.numel()
    spec = fft_op(x, None, cfg.fft)
    spec512 = fft_op(x, small.log2_fft_size, cfg.fft)
    taps = rsp.golden.lfm_chirp(128, 0.0, 0.25)
    rd_cfg = rsp.ChainConfig(
        fft=cfg.fft, cfar=cfg.cfar,
        matched_filter=rsp.MatchedFilterConfig(num_taps=128,
                                               fft_size=SHAPE[-1]),
        doppler=rsp.DopplerConfig(num_pulses=SHAPE[1]))
    rd_map = krd.fused_rd_chain(x, rt, taps, rd_cfg, emit="map")
    cfg2d, far2d = (rsp.Cfar2dConfig(**c) for c in (RD2_CFG, RD2_FAR_CFG))
    rt2d = rsp.Cfar2dRuntime.make(**RD2_REGS)
    rt2d_far = rsp.Cfar2dRuntime.make(**{**RD2_REGS, **RD2_FAR_SWEEP[0][2]})
    xq = rsp.C(*(torch.round(torch.clamp(v * 250, -32767, 32767))
                 for v in (x.re, x.im)))
    xi = rsp.C(xq.re.to(torch.int32), xq.im.to(torch.int32))
    words = rsp.packing.pack_iq(xq)
    bit_true = rsp.FixedPointConfig(enabled=True, width=16, bin_point=0,
                                    bit_true=True)
    icfg = dataclasses.replace(cfg, fixed_point=bit_true)
    igcfg = dataclasses.replace(gcfg, fixed_point=bit_true)
    grt = rsp.RuntimeConfig.make(**GOS_REGS)
    row = SP.scatter(spec, SP.make_mesh(1, 4, [dev] * 4), channels=False,
                     ranges=True)[0]
    exts = khalo.mag_extend(row, 128, rt.mag_mode)
    scfg = dataclasses.replace(cfg.cfar, use_rdma_halo=True)
    shards = ((128, 512), (0, 512), (0, 512), (0, 384))
    points = {
        "chain_ca at 64x256x1024 (yardstick)":
            lambda: kchain.chain_ca(x, rt, cfg.fft, cfg.cfar),
        "wire_ca at 64x256x1024, headline":
            lambda: kchain.wire_ca(words, rt, cfg.fft, cfg.cfar),
        "wire_ca at 64x256x1024, GO grouping":
            lambda r=rt.merge_regs(cfar_mode=1, peak_grouping=1):
            kchain.wire_ca(words, r, cfg.fft, cfg.cfar),
        "rd_ca at 64x256x1024, headline":
            lambda: krd.fused_rd_chain(x, rt, taps, rd_cfg),
        "rd_map at 64x256x1024, headline":
            lambda: krd.fused_rd_chain(x, rt, taps, rd_cfg, emit="map"),
        "rd_2d at 64x256x1024, bench 2-D registers":
            lambda: krd.fused_rd_2d_chain(x, rt, rt2d, taps, rd_cfg, cfg2d),
        "rd_2d at 64x256x1024, Doppler reach 80":
            lambda: krd.fused_rd_2d_chain(x, rt, rt2d_far, taps, rd_cfg,
                                          far2d),
        "chain_int at 64x256x1024, headline":
            lambda: kint.chain_int(xi, rt, icfg.fft, icfg.cfar),
        "chain_int_gos at 64x256x1024, GOS registers":
            lambda: kint.chain_int_gos(xi, grt, igcfg.fft, igcfg.cfar),
        "chain_gos at 64x256x1024, GOS registers":
            lambda: kchain.chain_gos(x, grt, gcfg.fft, gcfg.cfar),
        "chain_gos at 64x256x1024, CASH registers":
            lambda r=grt.merge_regs(cfar_mode=3, sub_window_size=8):
            kchain.chain_gos(x, r, gcfg.fft, gcfg.cfar),
        "mag_cfar at 64x256x1024, headline":
            lambda: kcfar.mag_cfar(spec, rt, cfg.cfar),
        "mag_cfar at 64x256x1024, fft_size 512 spectrum":
            lambda: kcfar.mag_cfar(spec512, small, cfg.cfar),
        "mag_cfar at 64x256x1024, GOSCA elaboration, CA registers":
            lambda: kcfar.fused_mag_gos_dispatch(spec, rt, gcfg.cfar),
        "mag_cfar at 64x256x1024, the range-Doppler map":
            lambda: kcfar.mag_cfar(rd_map, rt, cfg.cfar),
        "mag_cfar on the given magnitude, 1x4 mesh of 16384 x 512 "
        "extended blocks": lambda: [
            kcfar.mag_cfar(e, rt, scfg, active_lo=lo, active_hi=hi,
                           mag_given=True)
            for e, (lo, hi) in zip(exts, shards)],
    }
    for (w, g), alg in ((wg, a) for wg in SEL_WINDOWS for a in (1, 0)):
        r = sel_registers(w, g).merge_regs(cfar_algorithm=alg)
        for name, fn in (
                ("chain_gos", lambda r=r: kchain.chain_gos(
                    x, r, gcfg.fft, gcfg.cfar)),
                ("mag_gos_cfar", lambda r=r: kcfar.mag_gos_cfar(
                    spec, r, gcfg.cfar)),
                ("chain_int_gos", lambda r=r: kint.chain_int_gos(
                    xi, r, igcfg.fft, igcfg.cfar))):
            points[sel_label(name, w, g, alg)] = fn
    for n, v in b_frame_sizes(dev, samples).items():
        points[f"mag_cfar at {v.shape[0]}x{n}, headline registers"] = (
            lambda v=v, r=rt.merge_regs(cfar_fft_size=n):
            kcfar.mag_cfar(v, r, cfg.cfar))
    for n, (v, c, h) in pc_frame_sizes(dev, taps, samples).items():
        points[f"pc_ca at {v.shape[0]}x{n}, bench registers"] = (
            lambda v=v, c=c, h=h, r=rsp.RuntimeConfig.make(
                **{**PC_REGS, "fft_size": n}):
            kchain.pc_ca(v, r, c.fft, c.cfar, h))
    flat = rsp.C(xi.re.reshape(-1), xi.im.reshape(-1))
    for f, n in MID_SHAPES:
        v = rsp.C(flat.re[:f * n].reshape(f, n), flat.im[:f * n].reshape(f, n))
        for name, fn, c, regs in (
                ("chain_int", kint.chain_int, icfg, HEADLINE),
                ("chain_int_gos", kint.chain_int_gos, igcfg, GOS_REGS)):
            points[mid_label(name, f, n)] = (
                lambda v=v, fn=fn, c=at_size(c, n), r=rsp.RuntimeConfig.make(
                    **{**regs, "fft_size": n}): fn(v, r, c.fft, c.cfar))
    split0 = []
    for f, n in SPLIT_SHAPES:
        v = rsp.C(flat.re[:f * n].reshape(f, n), flat.im[:f * n].reshape(f, n))
        for name, fn, c, regs in (
                ("chain_int_split", kint.chain_int, icfg, HEADLINE),
                ("chain_int_gos_split", kint.chain_int_gos, igcfg, GOS_REGS)):
            label = (f"{name} at {f}x{n}, "
                     f"{'GOS' if c is igcfg else 'headline'} registers")
            points[label] = (
                lambda v=v, fn=fn, c=at_size(c, n), r=rsp.RuntimeConfig.make(
                    **{**regs, "fft_size": n}): fn(v, r, c.fft, c.cfar))
            if (f, n) == SPLIT_SHAPES[0]:
                split0.append(label)
    times = {name: (time_ms(fn), device_ms(fn), host_call_ms(fn))
             for name, fn in points.items()}
    if profiles:
        for label in split0:
            profile(points[label], label, ())
        for label in ("rd_ca at 64x256x1024, headline",
                      "rd_map at 64x256x1024, headline",
                      "rd_2d at 64x256x1024, bench 2-D registers",
                      "rd_2d at 64x256x1024, Doppler reach 80"):
            launch_split(points[label], label)
    return times


def row_blocks(card: str, x, xi, spec, rt, cfg, x2, rt_pc, pc_cfg,
               h_pc, words, grt, gcfg, igcfg) -> None:
    """The row kernels of Kernels A, D, E, F, G and I and Kernel B built
    with each of ``ROW_BLOCKS`` blocks an SM in their launch bounds
    (``-DRSP_ROWS_BLOCKS``, ``-DRSP_E_BLOCKS``, ``-DRSP_B_BLOCKS``; only
    their seven sources, all builds at once), each held against its plain
    version on the frames ``x`` (A at the bench bar; D under the GOS
    registers ``grt`` of ``gcfg``, the bench bar), ``words`` (E at the wire
    bar), ``xi`` (F, and G under ``grt`` of ``igcfg``, equal), ``x2`` (I at
    N = 4096, the bench bar) and the spectrum ``spec`` (B, the bench bar),
    with its registers, spills and stack, and timed in turns
    (``ROW_BLOCKS``, then reversed), each time the mean of its two. The
    entries are called directly, so the times hold little host work."""
    import ctypes

    import torch

    from rsp_chains_tpu_torch import CfarOutput
    from rsp_chains_tpu_torch.kernels import _build
    from rsp_chains_tpu_torch.kernels import cfar as kcfar
    from rsp_chains_tpu_torch.kernels import chain as kchain
    from rsp_chains_tpu_torch.kernels import int_chain as kint
    from rsp_chains_tpu_torch.ops.fft import fft_scale

    sources = ("chain_ca.cu", "chain_gos.cu", "wire_ca.cu", "chain_int.cu",
               "chain_int_gos.cu", "pc_ca.cu", "mag_cfar.cu")
    flags = [(f"-DRSP_ROWS_BLOCKS={b}", f"-DRSP_B_BLOCKS={b}",
              f"-DRSP_E_BLOCKS={b}") for b in ROW_BLOCKS]
    t0 = time.perf_counter()
    libs = _build.variants(sources, flags)
    print(f"build of {', '.join(sources)} at {ROW_BLOCKS} blocks an SM: "
          f"{time.perf_counter() - t0:.2f} s")
    dev, n, n2 = x.re.device, x.shape[-1], x2.shape[-1]
    P, I = ctypes.c_void_p, ctypes.c_int
    kernels = {  # name: (entry, kernel argument types, frames, dtype, args)
        "chain_ca": ("rsp_chain_ca", [P, I, ctypes.c_float, kcfar.CaRegs], x,
                     torch.float32, (
                         kchain._row_twiddles(n, dev).data_ptr(),
                         n.bit_length() - 1, fft_scale(n, cfg.fft),
                         kcfar.ca_registers(rt, cfg.cfar, n))),
        "chain_gos": ("rsp_chain_gos",
                      [P, I, ctypes.c_float, kcfar.GosRegs, P], x,
                      torch.float32, (
                          kchain._row_twiddles(n, dev).data_ptr(),
                          n.bit_length() - 1, fft_scale(n, gcfg.fft),
                          kcfar.gos_registers(grt, gcfg.cfar, n), None)),
        "chain_int": ("rsp_chain_int_rows", [P, I, I, I, kint.IntRegs], xi,
                      torch.int32, (
                          kint._int_twiddles(n, dev).data_ptr(),
                          n.bit_length() - 1, *kint.fft_masks(cfg.fft, n),
                          kint.int_registers(rt, cfg.cfar, n))),
        "chain_int_gos": ("rsp_chain_int_gos_rows",
                          [P, I, I, I, kint.IntRegs, P], xi, torch.int32, (
                              kint._int_twiddles(n, dev).data_ptr(),
                              n.bit_length() - 1,
                              *kint.fft_masks(igcfg.fft, n),
                              kint.int_registers(grt, igcfg.cfar, n), None)),
        "pc_ca": ("rsp_pc_ca", [P, P, I, ctypes.c_float, kcfar.CaRegs], x2,
                  torch.float32, (
                      kchain._row_twiddles(n2, dev).data_ptr(),
                      kchain._permuted(h_pc).data_ptr(), n2.bit_length() - 1,
                      fft_scale(n2, pc_cfg.fft),
                      kcfar.ca_registers(rt_pc, pc_cfg.cfar, n2))),
        "mag_cfar": ("rsp_mag_cfar", [I, kcfar.CaRegs, I], spec,
                     torch.float32, (n, kcfar.ca_registers(rt, cfg.cfar, n),
                                     0)),
    }

    def runner(lib, entry, types, v, dtype, args):
        fn = getattr(lib, entry)
        fn.argtypes = [P] * 4 + [I, P, *types]
        fn.restype = ctypes.c_int

        def run():
            thr = torch.empty(v.shape, dtype=dtype, device=dev)
            pk = torch.empty(v.shape, dtype=torch.uint8, device=dev)
            rc = fn(v.re.data_ptr(), v.im.data_ptr(), thr.data_ptr(),
                    pk.data_ptr(), v.re.numel() // v.shape[-1],
                    torch.cuda.current_stream(dev).cuda_stream, *args)
            if rc != 0:
                raise RuntimeError(f"{entry} launch failed with CUDA error {rc}")
            return CfarOutput(threshold=thr, peaks=pk.view(torch.bool))
        return run

    def wire_runner(lib):
        fn = lib.rsp_wire_ca
        fn.argtypes = [P, P, I, P, P, I, ctypes.c_float, kcfar.CaRegs]
        fn.restype = ctypes.c_int
        args = (kchain._row_twiddles(n, dev).data_ptr(), n.bit_length() - 1,
                fft_scale(n, cfg.fft), kcfar.ca_registers(rt, cfg.cfar, n))

        def run():
            out = torch.empty_like(words)
            rc = fn(words.data_ptr(), out.data_ptr(), words.numel() // n,
                    torch.cuda.current_stream(dev).cuda_stream, *args)
            if rc != 0:
                raise RuntimeError(f"rsp_wire_ca launch failed with CUDA "
                                   f"error {rc}")
            return out
        return run

    want_e = kchain.wire_ca_reference(words, rt, cfg.fft, cfg.cfar)
    want_a = kchain.chain_ca_reference(x, rt, cfg.fft, cfg.cfar)
    want_f = kint.chain_int_reference(xi, rt, cfg.fft, cfg.cfar)
    want_i = kchain.pc_ca_reference(x2, rt_pc, pc_cfg.fft, pc_cfg.cfar, h_pc)
    want_b = kcfar.mag_cfar_reference(spec, rt, cfg.cfar)
    want_d = chunked(lambda c: kchain.chain_gos_reference(
        c, grt, gcfg.fft, gcfg.cfar), x)
    want_g = chunked(lambda c: kint.chain_int_gos_reference(
        c, grt, igcfg.fft, igcfg.cfar), xi)
    runs = {}
    for b, f, lib in zip(ROW_BLOCKS, flags, libs):
        for name, (entry, types, v, dtype, args) in kernels.items():
            runs[name, b] = runner(lib, entry, types, v, dtype, args)
        runs["wire_ca", b] = wire_runner(lib)
        compare(runs["chain_ca", b](), want_a, f"chain_ca, {b} blocks an SM")
        compare_words(runs["wire_ca", b](), want_e, n.bit_length() - 1,
                      f"wire_ca, {b} blocks an SM")
        compare_exact(runs["chain_int", b](), want_f,
                      f"chain_int, {b} blocks an SM")
        compare(runs["chain_gos", b](), want_d, f"chain_gos, {b} blocks an SM")
        compare_exact(runs["chain_int_gos", b](), want_g,
                      f"chain_int_gos, {b} blocks an SM")
        compare(runs["pc_ca", b](), want_i, f"pc_ca, {b} blocks an SM")
        compare(runs["mag_cfar", b](), want_b, f"mag_cfar, {b} blocks an SM")
        for name, (regs, st, ld, stack) in ptxas_report(
                _build.build_log(sources, f), ("rsp_chain_ca_rows_kernel",
                                               "rsp_chain_gos_rows_kernel",
                                               "rsp_wire_ca_rows_kernel",
                                               "rsp_chain_int_rows_kernel",
                                               "rsp_chain_int_gos_rows_kernel",
                                               "rsp_pc_ca_rows_kernel",
                                               "rsp_mag_cfar_kernel")
        ).items():
            print(f"{b} blocks an SM: ptxas -v {name}: {regs} registers, {st} "
                  f"B spill stores, {ld} B spill loads, {stack} B stack frame")
    shapes = {name: v.shape for name, (_, _, v, _, _) in kernels.items()}
    shapes["wire_ca"] = words.shape
    for name, shape in shapes.items():
        ms = {b: [] for b in ROW_BLOCKS}
        for b in ROW_BLOCKS + ROW_BLOCKS[::-1]:
            ms[b].append(time_ms(runs[name, b]))
        for b, (t1, t2) in ms.items():
            print(f"{name} at {'x'.join(map(str, shape))}, {b} blocks an "
                  f"SM: {(t1 + t2) / 2:.4f} ms ({t1:.4f}, {t2:.4f}); card "
                  f"{card}")


def print_tail_times(times: dict, card: str) -> None:
    for name, (ms, dev_ms, host) in times.items():
        print(f"tail time: {name}: {ms:.4f} ms by events, {dev_ms:.4f} ms "
              f"on the card alone, {host:.4f} ms of host time a call; card "
              f"{card}")


def compare_mode(card: str) -> int:
    """``--compare``: build the kernels of the checkout this script lies in
    and print ``tail_times`` with the split route's and the range-Doppler
    kernels' per-launch profiles, nothing else; run from two checkouts in one call (a copy of this script
    in each) it compares their kernels on one card."""
    import torch

    from rsp_chains_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name})")
    print_tail_times(tail_times(torch.device("cuda", 0), profiles=True),
                     card)
    return 0


def headline_ca_config():
    """The CA elaboration of the headline frames: Kernel A's."""
    import rsp_chains_tpu_torch as rsp

    return rsp.ChainConfig(
        fft=rsp.FftConfig(max_size=SHAPE[-1]),
        cfar=rsp.CfarConfig(max_ref_window=64, variant=rsp.CfarVariant.CA,
                            include_cash=False, max_fft_size=SHAPE[-1]))


def rdma(c):
    """``c`` with the kernel halo (``CfarConfig(use_rdma_halo=True)``)."""
    return dataclasses.replace(c, cfar=dataclasses.replace(
        c.cfar, use_rdma_halo=True))


def plain_of(c):
    """``c`` with the plain CFAR ops (``use_pallas=False``)."""
    return dataclasses.replace(c, cfar=dataclasses.replace(
        c.cfar, use_pallas=False))


# the signal sources: rsp_chain_vanilla's frames are tones of the start
# word SRC_START plus each frame's offset (frame mod 8), so frame f peaks at
# bin (SRC_START + f mod 8) * N / (4 * table_size) = 32 + 2 (f mod 8); the
# fixed-point default runs one frame over SRC_STARTS
SRC_START = 16
SRC_STARTS = (8, 16, 24, 32, 48, 64, 100, 128)


def source_paths(dev, card: str, cfg, plain_cfg, gcfg, gplain_cfg,
                 sweep) -> list:
    """Drive the source tops at the headline CPI through their entry
    points, each path with the counters set to 0 just before it (``sweep``)
    and every point held against the plain chain on the card:
    ``rsp_chain_vanilla`` (float CA: Kernel B) on a [64, 256, 1024] CUDA
    profile, checking each frame's peak bin; ``chain_with_mem`` on a
    [64, 256, 1024] ROM of three tones and seeded noise under the default
    ``ChainConfig()`` (Kernel C under GOS registers, B under CA registers)
    and a CA elaboration; ``real_rx_chain`` on real [64, 256, 1024] frames
    (tones at 1/8 and 1/4 and seeded noise), the tail at 512 cells; the
    fixed-point default ``rsp_chain_vanilla()`` on one frame over
    ``SRC_STARTS`` (no kernel). Then times each path and the NCO alone by
    CUDA events. Returns the launches of each path."""
    import numpy as np
    import torch

    import rsp_chains_tpu_torch as rsp
    from rsp_chains_tpu_torch.kernels import _build
    from rsp_chains_tpu_torch.ops.nco import dither_stream, nco

    n = SHAPE[-1]
    frames = SHAPE[0] * SHAPE[1]
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    builds = _build.BUILDS

    def frame_bins(out, bins, what):
        """Every frame of ``out`` has a peak at each of its ``bins``."""
        pk = out.peaks.reshape(frames, -1)
        hit = torch.stack([pk[torch.arange(frames, device=dev), b]
                           for b in bins])
        missed = int((~hit.all(dim=0)).sum().item())
        print(f"{what}: {frames - missed} of {frames} frames peak at their "
              f"bins")
        if missed:
            raise AssertionError(f"{what}: {missed} frames miss their bins")

    # ---- rsp_chain_vanilla, float CA, a CPI of tones ----
    offs = (torch.arange(frames, device=dev) % 8).float()
    tones = offs.reshape(SHAPE[0], SHAPE[1], 1).expand(SHAPE).contiguous()
    walk = torch.randn(SHAPE, device=dev, generator=gen) * 40
    tone_bins = [(2 * (SRC_START + offs)).long()]
    van = rsp.rsp_chain_vanilla(cfg)
    van_plain = rsp.rsp_chain_vanilla(plain_cfg)
    assert van.stage_names == ("plfg_nco", "fft", "mag_cfar_fused"), \
        van.stage_names
    rt_v = rsp.RuntimeConfig.make(**HEADLINE, nco_freq_word=SRC_START,
                                  plfg_profile=tones)
    assert rt_v.plfg_profile is tones

    def van_check(out, name, rt_s):
        compare(out, van_plain(None, rt_s), f"rsp_chain_vanilla [{name}]")
        if rt_s.plfg_profile is tones:
            shift = [b + 2 * (rt_s.nco_freq_word - SRC_START)
                     for b in tone_bins]
            frame_bins(out, shift, f"rsp_chain_vanilla [{name}]")

    van_launches = sweep("rsp_chain_vanilla path", [
        ("CPI tones", rt_v, "mag_cfar"),
        ("CPI tones, phase offset 100.25",
         rt_v.merge_regs(phase_offset=100.25), "mag_cfar"),
        ("CPI tones, start word 24", rt_v.merge_regs(nco_freq_word=24),
         "mag_cfar"),
        ("seeded walk profile", rt_v.merge_regs(plfg_profile=walk),
         "mag_cfar")], lambda rt_s: van(None, rt_s), van_check)

    # ---- chain_with_mem: a ROM CPI of three tones and seeded noise ----
    i = torch.arange(n, device=dev, dtype=torch.float64)
    noise = torch.sqrt(torch.rand(SHAPE, device=dev, generator=gen)
                       + torch.rand(SHAPE, device=dev, generator=gen))
    t_re = sum(a * torch.cos(2 * np.pi * f * i)
               for a, f in ((0.4, 0.125), (0.2, 0.25), (0.1, 0.5)))
    t_im = sum(a * torch.sin(2 * np.pi * f * i)
               for a, f in ((0.4, 0.125), (0.2, 0.25), (0.1, 0.5)))
    rom = rsp.C(torch.trunc((noise + t_re.float()) * 2 ** 13),
                torch.trunc(t_im.float() * 2 ** 13).expand(SHAPE).contiguous())
    mem = rsp.chain_with_mem(gcfg, rom)
    mem_ca = rsp.chain_with_mem(cfg, rom)
    mem_plain = rsp.chain_with_mem(plain_cfg, rom)
    assert mem.stage_names == ("mem_rom", "fft", "mag_gos_cfar_fused"), \
        mem.stage_names
    rt = rsp.RuntimeConfig.make(**HEADLINE)
    grt = rsp.RuntimeConfig.make(**GOS_REGS)

    def mem_check(out, name, rt_s, top):
        if top is mem:
            want = chunked(lambda c: rsp.chain_with_mem(gplain_cfg, c)(
                None, rt_s), rom)
        else:
            want = mem_plain(None, rt_s)
        compare(out, want, f"chain_with_mem [{name}]")
        if rt_s.mem_start_reading == 0:
            if bool(out.peaks.any()) or bool(out.threshold.any()):
                raise AssertionError("the read gate is off and a cell fired")
            print(f"chain_with_mem [{name}]: no detections")
        else:
            frame_bins(out, (128, 256, 512), f"chain_with_mem [{name}]")

    mem_launches = sweep("chain_with_mem path", [
        ("GOSCA, GOS registers", grt, "mag_gos_cfar", mem),
        ("GOSCA, GOS CASH", grt.merge_regs(cfar_mode=3, sub_window_size=8),
         "mag_gos_cfar", mem),
        ("GOSCA, CA registers", rt, "mag_cfar", mem),
        ("CA elaboration", rt, "mag_cfar", mem_ca),
        ("GOSCA, read gate off", rt.merge_regs(mem_start_reading=0),
         "mag_cfar", mem)], lambda rt_s, top: top(None, rt_s), mem_check)

    # ---- real_rx_chain: real frames, the tail at N / 2 ----
    real = (3000 * torch.cos(2 * np.pi * i / 8)
            + 2000 * torch.cos(2 * np.pi * i / 4)).float() + 20 * torch.randn(
                SHAPE, device=dev, generator=gen)
    rx = rsp.real_rx_chain(gcfg)
    rx_ca = rsp.real_rx_chain(cfg)
    rx_plain = rsp.real_rx_chain(plain_cfg)
    assert rx.stage_names == ("rfft", "mag_gos_cfar_fused"), rx.stage_names
    rt_rx = rt.merge_regs(cfar_fft_size=n // 2)
    grt_rx = grt.merge_regs(cfar_fft_size=n // 2)

    def rx_check(out, name, rt_s, top):
        if out.threshold.shape != SHAPE[:-1] + (n // 2,):
            raise AssertionError(f"real_rx_chain [{name}]: shape "
                                 f"{tuple(out.threshold.shape)}")
        if top is rx:
            want = chunked(lambda c: rsp.real_rx_chain(gplain_cfg)(c, rt_s),
                           real)
        else:
            want = rx_plain(real, rt_s)
        compare(out, want, f"real_rx_chain [{name}]")
        frame_bins(out, (128, 256), f"real_rx_chain [{name}]")

    rx_launches = sweep("real_rx_chain path", [
        ("GOSCA, GOS registers", grt_rx, "mag_gos_cfar", rx),
        ("GOSCA, CA registers", rt_rx, "mag_cfar", rx),
        ("CA elaboration", rt_rx, "mag_cfar", rx_ca)],
        lambda rt_s, top: top(real, rt_s), rx_check)

    # ---- rsp_chain_vanilla() at its defaults: fixed point, plain ops ----
    van0 = rsp.rsp_chain_vanilla()
    van0_cpu = rsp.rsp_chain_vanilla(device="cpu")
    assert van0.stage_names == ("plfg_nco", "fft", "logmag", "cfar")

    def van0_check(out, name, rt_s):
        cpu = van0_cpu(None, rt_s)
        compare(out, rsp.CfarOutput(threshold=cpu.threshold.to(dev),
                                    peaks=cpu.peaks.to(dev)),
                f"rsp_chain_vanilla() [{name}] vs the CPU")
        got = torch.nonzero(out.peaks).flatten().tolist()
        if got != [2 * rt_s.nco_freq_word]:
            raise AssertionError(f"rsp_chain_vanilla() [{name}]: peaks {got}")
        print(f"rsp_chain_vanilla() [{name}]: peaks {got}")

    van0_launches = sweep("rsp_chain_vanilla() path", [
        (f"start {s}", rsp.RuntimeConfig.make(**HEADLINE, nco_freq_word=s),
         None) for s in SRC_STARTS], lambda rt_s: van0(None, rt_s),
        van0_check)
    if _build.BUILDS != builds:
        raise AssertionError("a source register write rebuilt the library")

    # ---- times: the paths and the NCO alone ----
    def chunk_ms(fn, v):
        return time_ms(lambda: chunked(fn, v), calls=10, warm=1)

    rt0 = rsp.RuntimeConfig.make(**HEADLINE, nco_freq_word=SRC_START)
    times = {
        "rsp_chain_vanilla float CA, CPI profile": (
            time_ms(lambda: van(None, rt_v)),
            time_ms(lambda: van_plain(None, rt_v), calls=10, warm=1)),
        "chain_with_mem GOSCA, GOS registers": (
            time_ms(lambda: mem(None, grt)),
            chunk_ms(lambda c: rsp.chain_with_mem(gplain_cfg, c)(None, grt),
                     rom)),
        "chain_with_mem GOSCA, CA registers": (
            time_ms(lambda: mem(None, rt)),
            chunk_ms(lambda c: rsp.chain_with_mem(gplain_cfg, c)(None, rt),
                     rom)),
        "real_rx_chain GOSCA, GOS registers": (
            time_ms(lambda: rx(real, grt_rx)),
            chunk_ms(lambda c: rsp.real_rx_chain(gplain_cfg)(c, grt_rx),
                     real)),
        "real_rx_chain GOSCA, CA registers": (
            time_ms(lambda: rx(real, rt_rx)),
            chunk_ms(lambda c: rsp.real_rx_chain(gplain_cfg)(c, rt_rx),
                     real)),
    }
    for name, (ms, plain_ms) in times.items():
        print(f"source {name} at {'x'.join(map(str, SHAPE))}: {ms:.4f} ms = "
              f"{frames * n / ms / 1e3:.1f} Msamples/s; plain chain "
              f"{plain_ms:.4f} ms; card {card}")
    print(f"source rsp_chain_vanilla() default, one frame of {n}: "
          f"{time_ms(lambda: van0(None, rt0)):.4f} ms; card {card}")
    profile(lambda: van(None, rt_v), "rsp_chain_vanilla float CA, CPI "
            "profile", van.stage_names)
    profile(lambda: rx(real, grt_rx), "real_rx_chain GOSCA, GOS registers",
            rx.stage_names)
    # the NCO alone on the CPI's words: 4 B a sample in, 8 out
    words = tones + float(SRC_START)
    nco_bytes = words.numel() * (4 + 8)
    nco_bound = nco_bytes / HBM_BYTES_PER_S * 1e3
    dither_stream.cache_clear()
    t = time.perf_counter()
    dither_stream(0x5EED, SHAPE, dev)
    torch.cuda.synchronize()
    print(f"NCO dither stream built on the card for "
          f"{'x'.join(map(str, SHAPE))}: {(time.perf_counter() - t) * 1e3:.1f} "
          f"ms once (host clock; cached after)")
    for label, nco_cfg in (
            ("float", cfg.nco),
            ("quantized table", dataclasses.replace(cfg.nco,
                                                    quantized_lut=True)),
            ("quantized table, dither", dataclasses.replace(
                cfg.nco, quantized_lut=True, dither_enable=True))):
        ms = time_ms(lambda c=nco_cfg: nco(words, c, pair=True))
        print(f"NCO {label} at {'x'.join(map(str, SHAPE))}: {ms:.4f} ms "
              f"against its bound {nco_bound:.4f} ms ({nco_bytes / 1e6:.1f} "
              f"MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), "
              f"{ms / nco_bound:.1f}x; card {card}")
    profile(lambda: nco(words, cfg.nco, pair=True), "NCO float", ())
    return [van_launches, mem_launches, rx_launches, van0_launches]


# the serving phase: the JAX bench's wire stream (bench.py:130-262), 16 x 256
# frames of 1024 beat words from seed 5, host-fed for WIRE_HOST_CPIS CPIs
# through the C++ scanner and device-fed for WIRE_DEVICE_CPIS (waiting on
# every WIRE_BLOCK_EVERY-th); the float headline stream of FLOAT_CPIS CPIs
# (detections fetched every FLOAT_DET_EVERY); POKE_CPIS CPIs with a CA -> GO
# poke halfway; SERVER_REQUESTS framed 1024-sample requests on each of two
# connections to a ChainServer of the default ChainConfig()
WIRE_SHAPE = (16, 256, 1024)
WIRE_HOST_CPIS, WIRE_DEVICE_CPIS, WIRE_BLOCK_EVERY = 12, 40, 8
FLOAT_CPIS, FLOAT_DET_EVERY, POKE_CPIS = 16, 4, 24
SERVER_REQUESTS = 150


def wait_for(cond, what: str, limit: float = 300.0) -> None:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > limit:
            raise AssertionError(f"timed out after {limit} s waiting for "
                                 f"{what}")
        time.sleep(0.002)


def phase_table(ph0: dict, ph1: dict, n: int) -> str:
    """Each ``phase_totals()`` key's delta a CPI: seconds as ms, a count as
    a count."""
    return ", ".join(f"{k[2:]} {(ph1[k] - ph0[k]) / n * 1e3:.3f}"
                     if k.startswith("t_") else
                     f"{k[2:]} {(ph1[k] - ph0[k]) / n:.2f}" for k in ph1)


def client_reply(sock, dec, pending):
    """The next reply frame on ``sock`` (60 s at most)."""
    t0 = time.perf_counter()
    while not pending:
        if time.perf_counter() - t0 > 60:
            raise AssertionError("no reply within 60 s")
        chunk = sock.recv(1 << 16)
        if not chunk:
            raise AssertionError("the server closed the connection")
        pending.extend(dec.feed(chunk))
    return pending.pop(0)


def serve_clients(port: str, reqs_path: str, out_path: str) -> int:
    """``--serve-clients PORT REQS OUT``: the ChainServer's two clients, run
    by ``serving_paths`` in a process of their own. Connection c sends the
    requests ``REQS[c]`` on channel c + 1, each waiting for its reply; then,
    once connection 1 has its last reply, connection 0 writes
    ``threshold_scaler`` and sends one request, writes
    ``mem_run_last=0`` and sends one more. Saves each connection's reply
    words and (seq, channel, last), the latencies and the wall time."""
    import socket
    import threading

    import numpy as np

    from rsp_chains_tpu_torch.io import framing

    reqs = np.load(reqs_path)

    def config_frame(kw):
        payload = json.dumps(kw).encode() + b"\0"
        payload += b"\0" * ((-len(payload)) % 4)
        return framing.encode_frame(np.frombuffer(payload, np.uint32), 0,
                                    config=True)

    replies, lat, errors = {}, [], []
    # a register write applies to every later CPI, whichever connection
    # sent it: connection 0 writes only after connection 1's last reply
    others_done = threading.Event()

    def client(c):
        try:
            with socket.create_connection(("127.0.0.1", int(port)),
                                          timeout=60) as sock:
                sock.settimeout(60)
                dec, pending, mine = framing.FrameDecoder(), [], []
                for i, iq in enumerate(reqs[c]):
                    t = time.perf_counter()
                    sock.sendall(framing.encode_iq_frame(iq, i, last=True,
                                                         channel=c + 1))
                    mine.append(client_reply(sock, dec, pending))
                    lat.append(time.perf_counter() - t)
                if c == 1:
                    others_done.set()
                else:
                    if not others_done.wait(timeout=240):
                        raise TimeoutError("connection 1 never finished")
                    for seq, kw, iq in ((1000, {"threshold_scaler": 5.0},
                                         reqs[0][0]),
                                        (1001, {"mem_run_last": 0},
                                         reqs[0][1])):
                        sock.sendall(config_frame(kw))
                        sock.sendall(framing.encode_iq_frame(iq, seq,
                                                             channel=1))
                        mine.append(client_reply(sock, dec, pending))
                replies[c] = mine
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
        finally:
            if c == 1:
                others_done.set()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    dt = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        print(f"a client failed: {errors}", file=sys.stderr)
        return 1
    out = {"lat": np.asarray(lat), "dt": np.asarray(dt)}
    for c, mine in replies.items():
        out[f"words{c}"] = np.stack([f.words for f in mine])
        out[f"meta{c}"] = np.asarray([(f.seq, f.channel, f.last)
                                      for f in mine])
    np.savez(out_path, **out)
    return 0


def serving_paths(dev, card: str, cfg) -> list:
    """The serving and control plane on the card, each path with the
    counters set to 0 just before it and read just after: the JAX bench's
    wire stream through ``StreamingPipeline`` on Kernel E, host-fed (the
    C++ scanner recovers each CPI from one CRC byte stream) and device-fed;
    the float headline stream on Kernel A; a ``ControlServer`` poke of
    ``cfar_mode`` halfway through a stream; ``ChainServer`` on the default
    ``ChainConfig()`` (Kernel D) over two connections from a client process
    (``--serve-clients``) with a config frame and a ``mem_run_last`` write,
    beside one frame through the chain directly and through the pipeline
    alone; a checkpoint of a half-filled
    ``CpiBuffer`` with the live registers, resumed; ``compact_detections``
    on the headline output against its CPU run; the CLI's ``selftest``,
    ``run`` and ``bench`` in this process. Every output is held bit for bit
    against direct calls of the same chain, and the direct calls at the
    shapes that only this phase gives a kernel (E's wire CPI, D's one
    frame) against the plain versions at the bar. Returns the launches of
    each path."""
    import contextlib
    import io
    import socket
    import tempfile
    import threading

    import numpy as np
    import torch

    import rsp_chains_tpu_torch as rsp
    from rsp_chains_tpu_torch import cli
    from rsp_chains_tpu_torch.io import StreamingPipeline, framing, native
    from rsp_chains_tpu_torch.io.control import ControlServer, poke
    from rsp_chains_tpu_torch.io.cpi import CpiBuffer, load_state
    from rsp_chains_tpu_torch.io.server import ChainServer
    from rsp_chains_tpu_torch.kernels import _build
    from rsp_chains_tpu_torch.kernels import chain as kchain
    from rsp_chains_tpu_torch.ops.detect import compact_detections
    from rsp_chains_tpu_torch.ops.fft import fft_op
    from rsp_chains_tpu_torch.ops.logmag import logmag

    launched = _build.LAUNCHES
    paths = []
    native._load()
    if not native.HAVE_NATIVE:
        raise AssertionError("the C++ frame scanner did not build (g++)")
    rt = rsp.RuntimeConfig.make(**HEADLINE)

    def check(pipe, n, what):
        st = pipe.stats
        if (st.frames_out, st.frames_failed, st.frames_dropped) != (n, 0, 0):
            raise AssertionError(f"{what}: {st.frames_out} out, "
                                 f"{st.frames_failed} failed, "
                                 f"{st.frames_dropped} dropped of {n}")

    def sync():
        torch.cuda.synchronize(dev)

    def took(path, want: dict):
        got = {k: v for k, v in launched.items() if v}
        print(f"serving {path} launches: {got}")
        if got != want:
            raise AssertionError(f"serving {path} took {got}, not {want}")
        paths.append(got)

    # ---- the JAX bench's wire stream on Kernel E ----
    ch, p, n = WIRE_SHAPE
    rng = np.random.RandomState(5)
    re = rng.randint(-20000, 20000, (ch * p, n)).astype(np.int32)
    im = rng.randint(-20000, 20000, (ch * p, n)).astype(np.int32)
    w_np = ((re.astype(np.uint16).astype(np.uint32) << 16)
            | im.astype(np.uint16).astype(np.uint32))
    stream_bytes = b"".join(framing.encode_frame(w_np[i], i)
                            for i in range(ch * p))
    wire = rsp.rx_fft_mag_cfar_tx_chain(cfg, device=dev)
    assert wire.stage_names == ("rx_fft_mag_cfar_tx_fused",), wire.stage_names
    probe = w_np.reshape(WIRE_SHAPE)
    dev_words = torch.from_numpy(probe.view(np.int32)).to(dev)
    direct = wire(probe, rt)
    compare_words(direct, kchain.wire_ca_reference(dev_words, rt, cfg.fft,
                                                   cfg.cfar),
                  n.bit_length() - 1, f"serving wire CPI "
                  f"{'x'.join(map(str, WIRE_SHAPE))}: wire_ca vs "
                  f"wire_ca_reference")
    samples = probe.size
    # one CPI's words from a pinned host tensor to the card
    pinned = torch.from_numpy(probe.view(np.int32)).pin_memory()
    h2d = []
    for _ in range(5):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        pinned.to(dev, non_blocking=True)
        b.record()
        b.synchronize()
        h2d.append(a.elapsed_time(b))
    h2d_ms = statistics.median(h2d)
    print(f"serving pinned host-to-device copy of one wire CPI "
          f"({pinned.nbytes / 1e6:.1f} MB): {h2d_ms:.4f} ms = "
          f"{pinned.nbytes / 1e6 / (h2d_ms / 1e3):.0f} MB/s (median of "
          f"5, CUDA events); card {card}")
    del pinned

    def differs(store, want):
        """on_result keeping each CPI's count of words unlike ``want``,
        summed on the pipeline's stream: the outputs themselves are freed,
        as a serving consumer frees them"""
        return lambda s, o, m: store.__setitem__(s, (o != want).sum())

    def all_equal(store, n, what):
        bad = sum(bool(int(v)) for v in store.values())
        if len(store) != n or bad:
            raise AssertionError(f"{what}: {bad} of {len(store)} CPIs differ "
                                 f"from the direct call ({n} expected)")

    outs = {}
    launched.clear()
    pipe = StreamingPipeline(wire, rt, depth=8, block_every=WIRE_BLOCK_EVERY,
                             on_result=differs(outs, direct))
    with pipe:
        pipe.submit(-1, dev_words)          # warm the dispatch path
        wait_for(lambda: -1 in outs, "the device-fed warm-up CPI")
        ph0 = pipe.stats.phase_totals()
        t0 = time.perf_counter()
        for k in range(WIRE_DEVICE_CPIS):
            pipe.submit(k, dev_words)
        wait_for(lambda: WIRE_DEVICE_CPIS - 1 in outs, "the device-fed CPIs")
        sync()
        dt = time.perf_counter() - t0
        ph1 = pipe.stats.phase_totals()
    check(pipe, WIRE_DEVICE_CPIS + 1, "device-fed wire stream")
    all_equal(outs, WIRE_DEVICE_CPIS + 1, "device-fed wire stream")
    took("wire stream, device-fed", {"wire_ca": WIRE_DEVICE_CPIS + 1})
    print(f"serving wire stream {'x'.join(map(str, WIRE_SHAPE))}, "
          f"device-fed, {WIRE_DEVICE_CPIS} CPIs, block_every "
          f"{WIRE_BLOCK_EVERY}: {dt / WIRE_DEVICE_CPIS * 1e3:.4f} ms per CPI "
          f"= {WIRE_DEVICE_CPIS * samples / dt / 1e6:.1f} Msamples/s; phase "
          f"ms per CPI: {phase_table(ph0, ph1, WIRE_DEVICE_CPIS)}; card "
          f"{card}")

    outs.clear()
    launched.clear()
    t_scan = 0.0
    pipe = StreamingPipeline(wire, rt, depth=4,
                             on_result=differs(outs, direct))
    t0 = time.perf_counter()
    with pipe:
        for k in range(WIRE_HOST_CPIS):
            ts = time.perf_counter()
            metas, _, skipped = native.scan_frames(stream_bytes, n,
                                                   max_frames=ch * p)
            if len(metas) != ch * p or skipped:
                raise AssertionError(f"scan found {len(metas)} frames, "
                                     f"skipped {skipped} bytes")
            rows = np.frombuffer(stream_bytes, np.uint32).reshape(ch * p, -1)
            off = metas[0][0] // 4
            words = rows[:, off:off + n].reshape(WIRE_SHAPE)
            t_scan += time.perf_counter() - ts
            pipe.submit(k, words)
        wait_for(lambda: len(outs) + pipe.stats.frames_failed
                 >= WIRE_HOST_CPIS, "the host-fed CPIs")
        sync()
        dt = time.perf_counter() - t0
    check(pipe, WIRE_HOST_CPIS, "host-fed wire stream")
    all_equal(outs, WIRE_HOST_CPIS, "host-fed wire stream")
    took("wire stream, host-fed", {"wire_ca": WIRE_HOST_CPIS})
    print(f"serving wire stream {'x'.join(map(str, WIRE_SHAPE))}, host-fed "
          f"(C++ scan of the {len(stream_bytes) / 1e6:.1f} MB CRC stream, "
          f"pinned ring), {WIRE_HOST_CPIS} CPIs: "
          f"{dt / WIRE_HOST_CPIS * 1e3:.4f} ms per CPI = "
          f"{WIRE_HOST_CPIS * samples / dt / 1e6:.1f} Msamples/s; scan "
          f"{t_scan / WIRE_HOST_CPIS * 1e3:.4f} ms per CPI; phase ms per "
          f"CPI: {pipe.stats.phase_ms_per_cpi()}; card {card}")
    del outs, direct, dev_words

    # ---- the float headline stream on Kernel A ----
    chain = rsp.fft_mag_cfar_chain(cfg, device=dev)
    assert chain.stage_names == ("fft_mag_cfar_fused",), chain.stage_names
    gen = np.random.default_rng(SEED + 10)
    cpis = []
    for _ in range(FLOAT_CPIS):
        c = np.empty(SHAPE, np.complex64)
        c.real = gen.standard_normal(SHAPE, np.float32)
        c.imag = gen.standard_normal(SHAPE, np.float32)
        cpis.append(c)
    go = rt.merge_regs(cfar_mode=1)
    want = [chain(c, rt) for c in cpis]
    want_go = [chain(c, go) for c in cpis]
    total = sum(int(w.peaks.sum()) for w in want)
    sync()

    def against(store, regs_want):
        """on_result keeping, for each register file's direct results, the
        count of cells where the CPI differs (threshold and peaks)"""
        def keep(s, o, m):
            store[s] = [(o.threshold != w[s % FLOAT_CPIS].threshold).sum()
                        + (o.peaks != w[s % FLOAT_CPIS].peaks).sum()
                        for w in regs_want]
        return keep

    got = {}
    launched.clear()
    pipe = StreamingPipeline(chain, rt, detections_every=FLOAT_DET_EVERY,
                             on_result=against(got, [want]))
    t0 = time.perf_counter()
    with pipe:
        for k, c in enumerate(cpis):
            pipe.submit(k, c)
        wait_for(lambda: len(got) + pipe.stats.frames_failed >= FLOAT_CPIS,
                 "the float CPIs")
        sync()
        dt = time.perf_counter() - t0
    check(pipe, FLOAT_CPIS, "float headline stream")
    all_equal({k: v[0] for k, v in got.items()}, FLOAT_CPIS,
              "float headline stream")
    if pipe.detections_total != total:
        raise AssertionError(f"detections_total {pipe.detections_total} != "
                             f"{total}")
    took("float headline stream", {"chain_ca": FLOAT_CPIS})
    print(f"serving float headline stream {'x'.join(map(str, SHAPE))}, "
          f"host-fed complex64, {FLOAT_CPIS} CPIs: "
          f"{dt / FLOAT_CPIS * 1e3:.4f} ms per CPI = "
          f"{FLOAT_CPIS * SHAPE[0] * SHAPE[1] * SHAPE[2] / dt / 1e6:.1f} "
          f"Msamples/s; detections_total {pipe.detections_total} (exact, "
          f"fetched every {FLOAT_DET_EVERY}); phase ms per CPI: "
          f"{pipe.stats.phase_ms_per_cpi()}; card {card}")

    # ---- a poke of cfar_mode CA -> GO halfway through a stream ----
    got = {}
    builds = _build.BUILDS
    launched.clear()
    pipe = StreamingPipeline(chain, rt,
                             on_result=against(got, [want, want_go]))
    with pipe, ControlServer(lambda: pipe.runtime, pipe.reconfigure,
                             cfar_cfg=cfg.cfar,
                             update_rt=pipe.update_runtime) as ctrl:
        for k in range(POKE_CPIS):
            if k == POKE_CPIS // 2:
                poke("127.0.0.1", ctrl.port, {"cfar_mode": 1})
            pipe.submit(k, cpis[k % FLOAT_CPIS])
        wait_for(lambda: len(got) + pipe.stats.frames_failed >= POKE_CPIS,
                 "the poked stream")
        live = pipe.runtime
    check(pipe, POKE_CPIS, "poked stream")
    side = []
    for k in range(POKE_CPIS):
        old, new = (int(v) == 0 for v in got[k])
        if old == new:
            raise AssertionError(f"poked CPI {k} equals "
                                 f"{'both' if old else 'neither'} register "
                                 f"file's direct result")
        side.append(new)
    switch = side.index(True) if True in side else POKE_CPIS
    if side != [False] * switch + [True] * (POKE_CPIS - switch) or \
            switch > POKE_CPIS // 2:
        raise AssertionError(f"the poke did not land once at a CPI "
                             f"boundary: {side}")
    if _build.BUILDS != builds or live.cfar_mode != 1:
        raise AssertionError("the poke rebuilt the library or was lost")
    took("poked stream", {"chain_ca": POKE_CPIS})
    print(f"serving poke cfar_mode CA -> GO sent before CPI "
          f"{POKE_CPIS // 2} of {POKE_CPIS}: landed whole from CPI {switch} "
          f"(old registers before, new after, each CPI equal to one direct "
          f"result); library builds {_build.BUILDS}")

    # ---- a checkpoint of a half-filled CPI buffer, resumed ----
    with tempfile.TemporaryDirectory() as tmp:
        buf = CpiBuffer(num_pulses=SHAPE[1], n_range=SHAPE[2],
                        channels=SHAPE[0])
        half = SHAPE[1] // 2
        for k in range(half):
            buf.push(cpis[0][:, k])
        launched.clear()
        res = {}
        pipe = StreamingPipeline(chain, live, on_result=lambda s, o, m:
                                 res.__setitem__(s, o))
        pipe.checkpoint(f"{tmp}/ckpt", buf, cursor=half)
        buf2 = CpiBuffer(num_pulses=SHAPE[1], n_range=SHAPE[2],
                         channels=SHAPE[0])
        rt2, extras = load_state(f"{tmp}/ckpt", buf2)
        pipe2 = StreamingPipeline(chain, rt2, on_result=lambda s, o, m:
                                  res.__setitem__(s + 1, o))
        for pp, b in ((pipe, buf), (pipe2, buf2)):
            with pp:
                for k in range(half, SHAPE[1]):
                    cpi = b.push(cpis[0][:, k])
                pp.submit(0, cpi)
                wait_for(lambda: len(res) + pp.stats.frames_failed
                         >= (1 if pp is pipe else 2), "the resumed CPI")
            check(pp, 1, "checkpoint resume")
    if not (rt2.peek() == live.peek() and int(extras["cursor"]) == half
            and torch.equal(res[0].threshold, res[1].threshold)
            and torch.equal(res[0].peaks, res[1].peaks)
            and torch.equal(res[0].threshold, want_go[0].threshold)):
        raise AssertionError("the resumed pipeline differs from the original")
    took("checkpoint resume", {"chain_ca": 2})
    print(f"serving checkpoint of a {SHAPE[0]}-channel CpiBuffer at pulse "
          f"{half} of {SHAPE[1]} with the live registers (cfar_mode "
          f"{rt2.cfar_mode}): resumed, the CPI equal bit for bit")

    # ---- compact_detections on the headline output ----
    x0 = rsp.as_pair(cpis[0], device=dev)
    mag = logmag(fft_op(x0, None, cfg.fft), rt.mag_mode, cfg.mag)
    dl = compact_detections(mag, want[0], 64)
    dl_cpu = compact_detections(mag.cpu(), rsp.CfarOutput(
        want[0].threshold.cpu(), want[0].peaks.cpu()), 64)
    for a, b in zip(dl, dl_cpu):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("compact_detections on the card differs "
                                 "from its CPU run")
    print(f"serving compact_detections, top 64 of {SHAPE[0] * SHAPE[1]} "
          f"frames: equal to its CPU run; detections listed "
          f"{int(dl.count.sum())}")
    del cpis, want, want_go, got, res

    # ---- ChainServer on the default ChainConfig(), Kernel D ----
    gchain = rsp.fft_mag_cfar_chain(device=dev)
    grt = rsp.RuntimeConfig.make(**GOS_REGS)
    grng = np.random.RandomState(SEED + 11)
    reqs = [[(grng.randn(n) * 300 + 1j * grng.randn(n) * 300).astype(
        np.complex64) for _ in range(SERVER_REQUESTS)] for _ in range(2)]

    launched.clear()
    srv = ChainServer(gchain, grt, frame_len=n, log2_fft_size=10,
                      cfar_cfg=gchain.cfg.cfar)
    with srv, tempfile.TemporaryDirectory() as tmp:
        # one request first: the pipeline's first CPI pays the warm-up
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=60) as warm:
            warm.settimeout(60)
            warm.sendall(framing.encode_iq_frame(reqs[1][0], 0, channel=9))
            client_reply(warm, framing.FrameDecoder(), [])
        # the clients run in a process of their own, as a server's clients
        # do, so that their Python does not share the server's lock
        np.save(f"{tmp}/reqs.npy", np.asarray(reqs))
        proc = subprocess.run(
            [sys.executable, __file__, "--serve-clients", str(srv.port),
             f"{tmp}/reqs.npy", f"{tmp}/replies.npz"],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"the client process failed:\n"
                                 f"{proc.stdout}{proc.stderr}")
        check(srv._pipe, 2 * SERVER_REQUESTS + 3, "ChainServer")
        if srv.config_errors or srv.results_dropped:
            raise AssertionError("the server rejected a config frame or "
                                 "dropped a result")
        with np.load(f"{tmp}/replies.npz") as z:
            got = {k: z[k] for k in z.files}
    replies = {c: [framing.Frame(seq=int(m[0]), words=w, last=bool(m[2]),
                                 channel=int(m[1]))
                   for w, m in zip(got[f"words{c}"], got[f"meta{c}"])]
               for c in range(2)}
    lat, dt = list(got["lat"]), float(got["dt"])

    def words_of(iq, r):
        d = gchain(native.unpack_iq_c64(native.pack_iq_c64(iq))[None], r)
        return rsp.packing.pack_cfar_words(d.threshold[0], d.peaks[0], 10
                                           ).cpu().numpy().view(np.uint32)

    launched_server = dict(launched)
    hot = grt.merge_regs(threshold_scaler=5.0)
    for c in range(2):
        for i, f in enumerate(replies[c][:SERVER_REQUESTS]):
            if (f.seq, f.channel, f.last) != (i, c + 1, True) or \
                    not np.array_equal(f.words, words_of(reqs[c][i], grt)):
                raise AssertionError(f"reply {i} of connection {c} is "
                                     f"misrouted or differs")
    cfg_reply, last_reply = replies[0][SERVER_REQUESTS:]
    if not (cfg_reply.seq == 1000 and cfg_reply.last
            and np.array_equal(cfg_reply.words, words_of(reqs[0][0], hot))
            and not np.array_equal(cfg_reply.words,
                                   words_of(reqs[0][0], grt))):
        raise AssertionError("the config frame did not take effect from the "
                             "next frame")
    if not (last_reply.seq == 1001 and not last_reply.last
            and np.array_equal(last_reply.words, words_of(reqs[0][1], hot))):
        raise AssertionError("mem_run_last=0 did not clear FLAG_LAST")

    def served(frames):
        return torch.from_numpy(np.stack([f.words for f in frames]).view(
            np.int32)).to(dev)

    def plain_words(iqs, r):
        x = rsp.as_pair(np.stack([native.unpack_iq_c64(native.pack_iq_c64(iq))
                                  for iq in iqs]), device=dev)
        d = kchain.chain_gos_reference(x, r, gchain.cfg.fft, gchain.cfg.cfar)
        return rsp.packing.pack_cfar_words(d.threshold, d.peaks, 10)

    # Kernel D served one frame a launch, against its plain version
    compare_words(served(replies[0][:SERVER_REQUESTS]
                         + replies[1][:SERVER_REQUESTS]),
                  plain_words(reqs[0] + reqs[1], grt), 10,
                  f"serving ChainServer's {2 * SERVER_REQUESTS} replies "
                  f"(chain_gos on one frame) vs chain_gos_reference")
    compare_words(served([cfg_reply, last_reply]),
                  plain_words(reqs[0][:2], hot), 10,
                  "serving ChainServer's replies after the config frame vs "
                  "chain_gos_reference")
    launched.clear()
    launched.update(launched_server)
    took("ChainServer", {"chain_gos": 2 * SERVER_REQUESTS + 3})
    phases = srv.stats.phase_ms_per_cpi()
    # the layers under a served frame: the chain called directly on one
    # numpy frame, and the pipeline alone in a closed loop
    one = native.unpack_iq_c64(native.pack_iq_c64(reqs[0][0]))[None]
    launched.clear()
    direct_s = []
    for _ in range(SERVER_REQUESTS):
        t = time.perf_counter()
        gchain(one, grt).peaks.cpu()
        direct_s.append(time.perf_counter() - t)
    done = threading.Event()
    pipe_s = []
    pipe = StreamingPipeline(gchain, grt, on_result=lambda s, o, m: (
        o.peaks.cpu(), done.set()))
    with pipe:
        for k in range(SERVER_REQUESTS):
            done.clear()
            t = time.perf_counter()
            pipe.submit(k, one)
            if not done.wait(timeout=60):
                raise AssertionError("the pipeline did not answer in 60 s")
            pipe_s.append(time.perf_counter() - t)
    check(pipe, SERVER_REQUESTS, "closed-loop pipeline")
    took("served-frame layers", {"chain_gos": 2 * SERVER_REQUESTS})

    def pct(v):
        v = sorted(v)
        return (f"p50 {v[len(v) // 2] * 1e3:.3f} ms, p99 "
                f"{v[int(len(v) * 0.99)] * 1e3:.3f} ms")

    print(f"serving one {n}-sample frame, default ChainConfig(), GOS "
          f"registers: the chain called directly (numpy in, peaks to the "
          f"host) {pct(direct_s)}; the StreamingPipeline alone, closed loop "
          f"{pct(pipe_s)}; the ChainServer's phase ms per request: {phases} "
          f"(host clock); card {card}")
    lat.sort()
    print(f"serving ChainServer, default ChainConfig() (Kernel D), GOS "
          f"registers, {2 * SERVER_REQUESTS} requests of {n} samples over "
          f"two connections, each request waiting for its reply: "
          f"{2 * SERVER_REQUESTS / dt:.1f} requests/s; latency p50 "
          f"{lat[len(lat) // 2] * 1e3:.3f} ms, p99 "
          f"{lat[int(len(lat) * 0.99)] * 1e3:.3f} ms (host clock); config "
          f"frame and run_last took effect from the next frame; card {card}")

    # ---- the CLI in this process ----
    launched.clear()
    for argv in (["selftest"], ["run"], ["bench", "--preset",
                                         "fft_mag_cfar"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv + ["--device", dev.type])
        for line in buf.getvalue().splitlines():
            print(f"cli {' '.join(argv)}: {line}")
        if rc != 0:
            raise AssertionError(f"cli {' '.join(argv)} exited {rc}")
    cli_launches = {k: v for k, v in launched.items() if v}
    print(f"serving cli launches: {cli_launches}")
    if cli_launches.get("chain_ca", 0) < 1:
        raise AssertionError("the CLI's run and bench never launched Kernel A")
    paths.append(cli_launches)
    return paths


# the pod phase (parallel/multihost.py): two processes of this script, each
# a time block of every CPI batch [T, C, P, N] (bench.py:797-818, BASELINE
# config 5). Layout 1 is (cpi=2, ch=1, rng=1) at the headline width, each
# process's block one headline CPI on Kernel A: POD_CPIS streamed with a
# register write and a checkpoint after POD_WRITE_AFTER, then POD_TIMED
# timed; layout 2 is (cpi=2, ch=2, rng=2), four virtual shards of the card a
# process, on the kernel halo tail (L + B, and L + C under GOS registers)
POD_SHAPE = (2,) + SHAPE
POD_SHAPE2 = (2, 8) + SHAPE[1:]
POD_BATCHES = 4        # distinct seeded batches; CPI k streams batch k % 4
POD_CPIS, POD_WRITE_AFTER, POD_TIMED = 8, 4, 16
POD_SCALERS = (3.5, 5.0)   # threshold_scaler before and after the write
POD_GROUP_S = 300      # the process group's timeout on a collective
POD_CHILD_S = 600      # each child process's time limit


def pod_batches(shape, count: int, seed: int) -> list:
    """``count`` complex64 CPI batches of ``shape`` from ``seed``: the same
    on every process (replicated ingest)."""
    import numpy as np

    gen = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        c = np.empty(shape, np.complex64)
        c.real = gen.standard_normal(shape, np.float32)
        c.imag = gen.standard_normal(shape, np.float32)
        out.append(c)
    return out


def pod_device(rank: int, spread: bool):
    import torch

    return torch.device("cuda", rank if spread else 0)


def pod_child(rank: str, init: str, outdir: str, *mode: str) -> int:
    """``--pod-rank RANK INIT OUTDIR [spread]``: one of the pod phase's two
    processes, meeting the other at the ``file://`` store INIT. Both hold
    ``cuda:0``, or with ``spread`` card RANK each (layout 1 only). It loads
    the library the parent built (``BUILDS`` must stay 1), drives the pod
    pipeline with the counters set to 0 just before each layout and read
    just after, holds each of its shards against the plain chain on the card
    at the bench bar and one frame against ``golden.cfar_golden``, times
    layout 1, and writes its report to OUTDIR."""
    import os

    import numpy as np
    import torch

    import rsp_chains_tpu_torch as rsp
    from rsp_chains_tpu_torch.golden import models as golden_models
    from rsp_chains_tpu_torch.io.cpi import load_state
    from rsp_chains_tpu_torch.kernels import _build
    from rsp_chains_tpu_torch.parallel import multihost as MH

    rank, spread = int(rank), mode == ("spread",)
    dev = pod_device(rank, spread)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the two processes share the host: each takes half its cores, as the
    # processes of a deployment that share a host would
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // 2))
    if not _build.library_path().exists():
        raise AssertionError("the kernel library the parent built is missing")
    _build.library()
    MH.initialize_cluster(num_processes=2, process_id=rank, init_method=init,
                          timeout_s=POD_GROUP_S)
    launched = _build.LAUNCHES
    tag = f"pod{' [2 cards]' if spread else ''} rank {rank}"
    report = {"rank": rank}

    def sync():
        torch.cuda.synchronize(dev)

    def drained(pipe, n, what):
        # the drain counts a CPI (and reduces it) after it bumps frames_out
        wait_for(lambda: pipe.stats.frames_out + pipe.stats.frames_failed
                 >= n and pipe._det_n >= n, f"{tag}: {what}")
        st = pipe.stats
        if (st.frames_out, st.frames_failed) != (n, 0):
            raise AssertionError(f"{tag}: {what}: {st.frames_out} out, "
                                 f"{st.frames_failed} failed of {n}")

    def keeper(outs, dets):
        def keep(seq, out, m):
            outs[seq] = out
            dets[seq] = m.detections
        return keep

    def block_of(mesh):
        ((t, _),) = mesh.local_blocks()
        return t

    # ---- layout 1: (cpi=2, ch=1, rng=1) at the headline width, Kernel A ----
    cfg = headline_ca_config()
    chain = rsp.fft_mag_cfar_chain(cfg, device=dev)
    plain = rsp.fft_mag_cfar_chain(plain_of(cfg), device=dev)
    mesh = MH.make_pod_mesh(time_blocks=2, channels=1, range_shards=1,
                            devices=MH.global_devices([str(dev)]))
    t = block_of(mesh)
    batches = pod_batches(POD_SHAPE, POD_BATCHES, SEED + 20)
    rt = rsp.RuntimeConfig.make(**HEADLINE)
    regs = [rt, rt.merge_regs(threshold_scaler=POD_SCALERS[1])]

    def key(seq):
        return seq % POD_BATCHES, int(seq >= POD_WRITE_AFTER)

    want = {}
    for seq in range(POD_CPIS):
        b, r = key(seq)
        if (b, r) not in want:
            want[b, r] = plain(rsp.as_pair(batches[b][t:t + 1], device=dev),
                               regs[r])
    outs, dets = {}, {}
    ck = os.path.join(outdir, f"pod-ckpt{rank}{'-spread' if spread else ''}")
    sync()
    launched.clear()
    with MH.PodStreamingPipeline(chain, rt, mesh,
                                 on_result=keeper(outs, dets)) as pipe:
        for seq in range(POD_WRITE_AFTER):
            pipe.submit(seq, batches[key(seq)[0]])
        drained(pipe, POD_WRITE_AFTER, "the CPIs before the write")
        pipe.reconfigure(pipe.runtime.merge_regs(
            threshold_scaler=POD_SCALERS[1]))
        pipe.checkpoint(ck, next_seq=np.int64(POD_WRITE_AFTER))
    rt_back, extras = load_state(ck)
    start = int(extras["next_seq"])
    if start != POD_WRITE_AFTER or float(rt_back.threshold_scaler) != \
            POD_SCALERS[1]:
        raise AssertionError(f"{tag}: the checkpoint gave {start}, "
                             f"{rt_back.threshold_scaler}")
    with MH.PodStreamingPipeline(chain, rt_back, mesh,
                                 on_result=keeper(outs, dets)) as pipe2:
        for seq in range(start, POD_CPIS):
            pipe2.submit(seq, batches[key(seq)[0]])
        drained(pipe2, POD_CPIS - start, "the restored pipeline's CPIs")
    sync()
    report["launches1"] = {k: v for k, v in launched.items() if v}
    print(f"{tag} layout 1 launches: {report['launches1']}")
    if report["launches1"] != {"chain_ca": POD_CPIS}:
        raise AssertionError(f"{tag}: layout 1 took {report['launches1']}, "
                             f"not {POD_CPIS} chain_ca")
    for seq in range(POD_CPIS):
        (s,) = outs[seq]
        if (s.index[0].start, s.index[0].stop) != (t, t + 1):
            raise AssertionError(f"{tag}: CPI {seq} came back as rows "
                                 f"{s.index[0]}, not block {t}")
        compare(s.data, want[key(seq)], f"{tag} layout 1, CPI {seq} "
                f"(scaler {POD_SCALERS[key(seq)[1]]}), block {t}: Kernel A "
                f"vs the plain chain")
    report["dets1"] = [dets[seq] for seq in range(POD_CPIS)]
    report["plain1"] = [int(want[key(seq)].peaks.sum()) for seq in
                        range(POD_CPIS)]
    # one frame of the block against the numpy golden
    frame = batches[0][t, 0, 0].astype(np.complex128)
    g_thr, g_pk = golden_models.cfar_golden(
        golden_models.MAG_GOLDENS[rt.mag_mode](golden_models.fft_golden(
            frame)), ref_window=rt.ref_window_size,
        guard_window=rt.guard_window_size,
        threshold_scaler=rt.threshold_scaler, mode=rt.cfar_mode,
        div_sum=rt.div_sum, log_or_linear=rt.log_or_linear,
        peak_grouping=rt.peak_grouping)
    got = outs[0][0].data
    k_thr = got.threshold[0, 0, 0].double().cpu().numpy()
    k_pk = got.peaks[0, 0, 0].cpu().numpy()
    rel = float(np.abs(k_thr - g_thr).max() / np.abs(g_thr).max())
    flips = int((k_pk != g_pk).sum())
    print(f"{tag} layout 1, CPI 0, block {t}, frame (0, 0) against "
          f"golden.cfar_golden: rel dthr {rel:.3e}, peak flips {flips} of "
          f"{g_pk.size} cells, {int(g_pk.sum())} peaks")
    if not (rel < REL_BAR and flips <= FLIP_BAR * g_pk.size):
        raise AssertionError(f"{tag}: outside the bar against the golden")
    del outs, want

    # the timed stream: POD_TIMED batches, both processes starting together
    with MH.PodStreamingPipeline(chain, rt, mesh) as pipe:
        pipe.submit(-1, batches[0])
        drained(pipe, 1, "the warm-up CPI")
        torch.distributed.barrier()
        ph0 = pipe.stats.phase_totals()
        t0 = time.perf_counter()
        for k in range(POD_TIMED):
            pipe.submit(k, batches[k % POD_BATCHES])
        drained(pipe, POD_TIMED + 1, "the timed CPIs")
        sync()
        report["timed_s"] = time.perf_counter() - t0
        report["phases"] = phase_table(ph0, pipe.stats.phase_totals(),
                                       POD_TIMED)

    # ---- layout 2: (cpi=2, ch=2, rng=2), the kernel halo tail ----
    if not spread:
        mesh2 = MH.make_pod_mesh(time_blocks=2, channels=2, range_shards=2,
                                 devices=MH.global_devices([str(dev)] * 4))
        t = block_of(mesh2)
        batches2 = pod_batches(POD_SHAPE2, 2, SEED + 21)
        for name, c, r, kernel in (
                ("CA", rdma(cfg), rt, "mag_cfar"),
                ("GOSCA + CASH, GOS registers", rdma(rsp.ChainConfig()),
                 rsp.RuntimeConfig.make(**GOS_REGS), "mag_gos_cfar")):
            chain2 = rsp.fft_mag_cfar_chain(c, device=dev)
            plain2 = rsp.fft_mag_cfar_chain(plain_of(c), device=dev)
            wants = [plain2(rsp.as_pair(b[t:t + 1], device=dev), r)
                     for b in batches2]
            outs, dets = {}, {}
            sync()
            launched.clear()
            with MH.PodStreamingPipeline(chain2, r, mesh2,
                                         on_result=keeper(outs, dets)) as p:
                for seq, b in enumerate(batches2):
                    p.submit(seq, b)
                drained(p, len(batches2), f"layout 2 {name}")
            sync()
            got = {k: v for k, v in launched.items() if v}
            report[f"launches2 {name}"] = got
            print(f"{tag} layout 2 {name} launches: {got}")
            want_l = {"mag_extend": 4 * len(batches2),
                      kernel: 4 * len(batches2)}
            if got != want_l:
                raise AssertionError(f"{tag}: layout 2 {name} took {got}, "
                                     f"not {want_l}")
            for seq, w in enumerate(wants):
                compare(outs[seq][0].data, w, f"{tag} layout 2 (cpi=2, "
                        f"ch=2, rng=2) {name}, CPI {seq}, block {t}: "
                        f"cuFFT + mag_extend + {kernel} vs the plain chain")
            report[f"dets2 {name}"] = [dets[s] for s in range(len(wants))]
            report[f"plain2 {name}"] = [int(w.peaks.sum()) for w in wants]
    report["builds"] = _build.BUILDS
    if _build.BUILDS != 1:
        raise AssertionError(f"{tag}: the library was produced "
                             f"{_build.BUILDS} times, not once")
    with open(os.path.join(outdir, f"pod{rank}{'-spread' if spread else ''}"
                                   ".json"), "w") as f:
        json.dump(report, f)
    torch.distributed.destroy_process_group()
    return 0


def pod_spread_block(chain, batches, card: str) -> dict:
    """One process whose time blocks each spread over two cards: the
    ``(cpi, ch=2, rng=1)`` pod mesh over the first 2 or 4 cards, each block
    a sharded step (Kernel A on each card, gathered on the block's first
    card), the last block's on a card other than the pipeline's. Each shard
    is held against the plain chain; returns the launches."""
    import torch

    import rsp_chains_tpu_torch as rsp
    from rsp_chains_tpu_torch.kernels import _build
    from rsp_chains_tpu_torch.parallel import multihost as MH

    blocks = min(torch.cuda.device_count() // 2, POD_SHAPE[0])
    cards = [pod_device(i, True) for i in range(2 * blocks)]
    mesh = MH.make_pod_mesh(time_blocks=blocks, channels=2,
                            devices=MH.global_devices(cards))
    plain = rsp.fft_mag_cfar_chain(plain_of(chain.cfg), device=cards[0])
    rt = rsp.RuntimeConfig.make(**HEADLINE)
    outs = {}
    launched = _build.LAUNCHES
    launched.clear()
    with MH.PodStreamingPipeline(chain, rt, mesh, on_result=lambda s, o, m:
                                 outs.__setitem__(s, o)) as pipe:
        for seq in range(POD_BATCHES):
            pipe.submit(seq, batches[seq])
        wait_for(lambda: pipe.stats.frames_out + pipe.stats.frames_failed
                 >= POD_BATCHES, "the spread blocks' CPIs")
    for c in cards:
        torch.cuda.synchronize(c)
    got = {k: v for k, v in launched.items() if v}
    print(f"pod, one process, {blocks} time block(s) of 2 cards "
          f"({', '.join(map(str, cards))}) launches: {got}; card {card}")
    if pipe.stats.frames_failed or got != {
            "chain_ca": POD_BATCHES * POD_SHAPE[0] * 2}:
        raise AssertionError(f"pod spread blocks: {got}, "
                             f"{pipe.stats.frames_failed} failed")
    for seq in range(POD_BATCHES):
        for s in outs[seq]:
            rows = s.index[0]
            want = plain(rsp.as_pair(batches[seq][rows], device=cards[0]),
                         rt)
            here = type(s.data)(*(None if v is None else v.to(cards[0])
                                  for v in s.data))
            compare(here, want, f"pod, time block rows {rows.start}:"
                    f"{rows.stop} gathered on {s.data.threshold.device} "
                    f"from two cards, CPI {seq}: Kernel A vs the plain chain")
    return got


def pod_paths(dev, card: str, cfg) -> list:
    """The pod phase: two processes of this script (``--pod-rank``), each a
    time block of every CPI batch, layouts 1 and 2 on this card, and layout
    1 again with one process a card where there are two cards or more. A
    child that fails fails the phase. Checks that both processes report the
    same global count for every CPI, equal to the plain chain's peaks summed
    over both blocks; prints the pod's ms per CPI batch and Msamples/s (host
    clock ending in a synchronize, the slower process) beside one process's
    ``StreamingPipeline`` on the same batches, two of whose outputs are held
    against the plain chain. Returns the launches of each layout, summed
    over the processes."""
    import tempfile

    import numpy as np
    import torch

    import rsp_chains_tpu_torch as rsp
    from rsp_chains_tpu_torch.io import StreamingPipeline
    from rsp_chains_tpu_torch.kernels import _build

    paths = []
    samples = int(np.prod(POD_SHAPE))
    runs = [("", [])]
    if torch.cuda.device_count() >= 2:
        runs.append((" [2 cards]", ["spread"]))
    torch.cuda.empty_cache()   # the children allocate on the same card
    with tempfile.TemporaryDirectory() as tmp:
        for tag, extra in runs:
            t_wall = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, __file__, "--pod-rank", str(r),
                 f"file://{tmp}/store{len(extra)}", tmp, *extra],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for r in (0, 1)]
            done = []
            try:
                for p in procs:
                    out, err = p.communicate(timeout=POD_CHILD_S)
                    done.append((p.returncode, out, err))
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            t_wall = time.perf_counter() - t_wall
            for r, (rc, out, err) in enumerate(done):
                print(out, end="")
                if rc != 0:
                    raise AssertionError(f"pod{tag} rank {r} exited {rc}:\n"
                                         f"{err[-4000:]}")
            reps = []
            for r in (0, 1):
                with open(f"{tmp}/pod{r}{'-spread' if extra else ''}"
                          ".json") as f:
                    reps.append(json.load(f))
            for k in [k for k in reps[0] if k.startswith("dets")]:
                plain_k = k.replace("dets", "plain")
                want = [a + b for a, b in zip(reps[0][plain_k],
                                              reps[1][plain_k])]
                print(f"pod{tag} layout {k[4:]}: global detections a CPI, "
                      f"rank 0 {reps[0][k]}, rank 1 {reps[1][k]}; the plain "
                      f"chain's peaks summed over both blocks {want}")
                if not reps[0][k] == reps[1][k] == want:
                    raise AssertionError(f"pod{tag}: the global counts "
                                         f"{k} differ")
            for rep in reps:
                if rep["builds"] != 1:
                    raise AssertionError(f"pod{tag} rank {rep['rank']} "
                                         f"built {rep['builds']} times")
            for k in [k for k in reps[0] if k.startswith("launches")]:
                paths.append({n: reps[0][k].get(n, 0) + reps[1][k].get(n, 0)
                              for n in set(reps[0][k]) | set(reps[1][k])})
            slow = max(rep["timed_s"] for rep in reps)
            where = ("one process a card" if extra else "both processes on "
                     "one card, whose two CUDA contexts share it by time "
                     "slicing")
            print(f"pod{tag} layout 1 (cpi=2, ch=1, rng=1), CPI batches "
                  f"{'x'.join(map(str, POD_SHAPE))} complex64, {where}: "
                  f"{POD_TIMED} batches host-fed through PodStreamingPipeline "
                  f"on Kernel A, {slow / POD_TIMED * 1e3:.4f} ms per CPI "
                  f"batch = {POD_TIMED * samples / slow / 1e6:.1f} "
                  f"Msamples/s for the pod (host clock ending in a "
                  f"synchronize, the slower process; the global count "
                  f"reduced every CPI); phase ms per CPI: rank 0 "
                  f"{reps[0]['phases']}; rank 1 {reps[1]['phases']}; the "
                  f"phase's wall time {t_wall:.1f} s with the processes' "
                  f"start; card {card}")
    chain = rsp.fft_mag_cfar_chain(cfg, device=dev)
    batches = pod_batches(POD_SHAPE, POD_BATCHES, SEED + 20)
    if len(runs) == 1:
        print("pod phase on several cards: did not run: this host has one "
              "CUDA card; layout 1 runs with one process a card, and a "
              "time block spread over two cards, when "
              "torch.cuda.device_count() >= 2")
    else:
        paths.append(pod_spread_block(chain, batches, card))
    # the same batches through one process's StreamingPipeline: Kernel A on
    # 2 x 64 x 256 frames a launch; the warm-up's and the last batch's
    # outputs are held against the plain chain
    rt = rsp.RuntimeConfig.make(**HEADLINE)
    batch_of = {-1: 0, POD_TIMED - 1: (POD_TIMED - 1) % POD_BATCHES}
    keep = {}

    def keep_checked(seq, out, m):
        if seq in batch_of:
            keep[seq] = out

    launched = _build.LAUNCHES
    torch.cuda.synchronize(dev)
    launched.clear()
    with StreamingPipeline(chain, rt, on_result=keep_checked) as pipe:
        pipe.submit(-1, batches[0])
        wait_for(lambda: pipe.stats.frames_out >= 1, "the warm-up batch")
        ph0 = pipe.stats.phase_totals()
        t0 = time.perf_counter()
        for k in range(POD_TIMED):
            pipe.submit(k, batches[k % POD_BATCHES])
        wait_for(lambda: pipe.stats.frames_out >= POD_TIMED + 1,
                 "the timed batches")
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        ph1 = pipe.stats.phase_totals()
    if pipe.stats.frames_failed:
        raise AssertionError("the one-process stream failed a CPI")
    print(f"pod comparison: the same {POD_TIMED} CPI batches "
          f"{'x'.join(map(str, POD_SHAPE))} through one process's "
          f"StreamingPipeline on Kernel A: {dt / POD_TIMED * 1e3:.4f} ms per "
          f"CPI batch = {POD_TIMED * samples / dt / 1e6:.1f} Msamples/s "
          f"(host clock ending in a synchronize); phase ms per CPI: "
          f"{phase_table(ph0, ph1, POD_TIMED)}; card {card}")
    torch.cuda.synchronize(dev)
    got = {k: v for k, v in launched.items() if v}
    print(f"pod comparison launches: {got}")
    if got != {"chain_ca": POD_TIMED + 1}:
        raise AssertionError(f"the one-process stream took {got}, not "
                             f"{POD_TIMED + 1} chain_ca")
    paths.append(got)
    plain = rsp.fft_mag_cfar_chain(plain_of(cfg), device=dev)
    for seq, b in batch_of.items():
        compare(keep[seq], plain(rsp.as_pair(batches[b], device=dev), rt),
                f"pod comparison, one process, CPI {seq}: Kernel A on "
                f"{'x'.join(map(str, POD_SHAPE))} vs the plain chain")
    return paths


def main() -> int:
    if sys.argv[1:2] == ["--serve-clients"]:
        return serve_clients(*sys.argv[2:])
    if sys.argv[1:2] == ["--pod-rank"]:
        return pod_child(*sys.argv[2:])
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    if sys.argv[1:] == ["--compare"]:
        return compare_mode(card)
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2

    import rsp_chains_tpu_torch as rsp
    from rsp_chains_tpu_torch.kernels import _build
    from rsp_chains_tpu_torch.kernels import cfar as kcfar
    from rsp_chains_tpu_torch.kernels import chain as kchain
    from rsp_chains_tpu_torch.kernels import int_chain as kint
    from rsp_chains_tpu_torch.kernels import rd as krd
    from rsp_chains_tpu_torch.ops.cfar import window_registers
    from rsp_chains_tpu_torch.ops.fft import fft_op
    from rsp_chains_tpu_torch.ops.logmag import logmag
    from rsp_chains_tpu_torch.ops.matched_filter import h_planes

    launched = _build.LAUNCHES
    dev = torch.device("cuda", 0)
    # the plain path must be true fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- build ----
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name}); compiler report:")
    print(_build.build_log().strip())

    cfg = headline_ca_config()
    plain_cfg = plain_of(cfg)
    rng = np.random.RandomState(SEED)
    x = rsp.as_pair(rng.randn(*SHAPE).astype(np.float32)
                    + 1j * rng.randn(*SHAPE).astype(np.float32), device=dev)
    rt = rsp.RuntimeConfig.make(**HEADLINE)
    samples = x.re.numel()

    # ---- each kernel against its plain version ----
    err_a = compare(kchain.chain_ca(x, rt, cfg.fft, cfg.cfar),
                    kchain.chain_ca_reference(x, rt, cfg.fft, cfg.cfar),
                    "chain_ca vs chain_ca_reference")
    spec = fft_op(x, None, cfg.fft)
    err_b = compare(kcfar.mag_cfar(spec, rt, cfg.cfar),
                    kcfar.mag_cfar_reference(spec, rt, cfg.cfar),
                    "mag_cfar vs mag_cfar_reference")
    b_frames = b_frame_sizes(dev, samples)
    for n, v in b_frames.items():
        rt_n = rsp.RuntimeConfig.make(**{**HEADLINE, "cfar_fft_size": n,
                                         "peak_grouping": 1})
        cut = dict(active_lo=37, active_hi=n - 21)
        for label, u, kw in (
                ("whole frame", v, {}), ("active 37 .. N - 21", v, cut),
                ("given magnitude, active 37 .. N - 21",
                 logmag(v, rt_n.mag_mode), dict(cut, mag_given=True))):
            compare(kcfar.mag_cfar(u, rt_n, cfg.cfar, **kw),
                    kcfar.mag_cfar_reference(u, rt_n, cfg.cfar, **kw),
                    f"mag_cfar N {n} [{label}] vs mag_cfar_reference")

    gcfg = rsp.ChainConfig()  # the default elaboration: GOSCA + CASH
    gplain_cfg = plain_of(gcfg)
    grt = rsp.RuntimeConfig.make(**GOS_REGS)
    print(f"plain GOS versions run over {GOS_CHUNK}-channel chunks of the "
          f"{SHAPE[0]} channels (their window stacks)")
    got_d = kchain.chain_gos(x, grt, gcfg.fft, gcfg.cfar)
    err_d = compare(got_d, chunked(lambda c: kchain.chain_gos_reference(
        c, grt, gcfg.fft, gcfg.cfar), x), "chain_gos vs chain_gos_reference")
    compare_count(got_d, "chain_gos")
    err_c = compare(kcfar.mag_gos_cfar(spec, grt, gcfg.cfar),
                    chunked(lambda c: kcfar.mag_gos_cfar_reference(
                        c, grt, gcfg.cfar), spec),
                    "mag_gos_cfar vs mag_gos_cfar_reference")

    # the wire and bit-true kernels on the frames quantized as the JAX bench
    # quantizes them (bench.py:651-653, :703-706)
    def quantized(v):
        return torch.round(torch.clamp(v * 250, -32767, 32767))

    xq = rsp.C(quantized(x.re), quantized(x.im))
    xi16 = rsp.C(xq.re.to(torch.int32), xq.im.to(torch.int32))
    words = rsp.packing.pack_iq(xq)
    bw = SHAPE[-1].bit_length() - 1
    err_e = compare_words(kchain.wire_ca(words, rt, cfg.fft, cfg.cfar),
                          kchain.wire_ca_reference(words, rt, cfg.fft, cfg.cfar),
                          bw, "wire_ca vs wire_ca_reference")
    # Kernel E at each of its frame sizes over the wire points that take it
    for n in kchain.FUSABLE_SIZES:
        wn = words.reshape(-1, n)
        cfg_n = rsp.ChainConfig(fft=rsp.FftConfig(max_size=n), cfar=cfg.cfar)
        for name, kw, kernel in WIRE_SWEEP:
            if kernel == "wire_ca":
                rt_n = rsp.RuntimeConfig.make(**{**HEADLINE, "fft_size": n,
                                                 **kw})
                compare_words(
                    kchain.wire_ca(wn, rt_n, cfg_n.fft, cfg_n.cfar),
                    kchain.wire_ca_reference(wn, rt_n, cfg_n.fft,
                                             cfg_n.cfar),
                    n.bit_length() - 1,
                    f"wire_ca N {n} [{name}] vs wire_ca_reference")
    bit_true = rsp.FixedPointConfig(enabled=True, width=16, bin_point=0,
                                    bit_true=True)
    icfg = dataclasses.replace(cfg, fixed_point=bit_true)
    iplain_cfg = dataclasses.replace(plain_cfg, fixed_point=bit_true)
    igcfg = dataclasses.replace(gcfg, fixed_point=bit_true)
    igplain_cfg = dataclasses.replace(gplain_cfg, fixed_point=bit_true)
    err_f = compare_exact(kint.chain_int(xi16, rt, icfg.fft, icfg.cfar),
                          kint.chain_int_reference(xi16, rt, icfg.fft,
                                                   icfg.cfar),
                          "chain_int vs chain_int_reference")
    got_g = kint.chain_int_gos(xi16, grt, igcfg.fft, igcfg.cfar)
    err_g = compare_exact(got_g, chunked(
        lambda c: kint.chain_int_gos_reference(c, grt, igcfg.fft, igcfg.cfar),
        xi16), "chain_int_gos vs chain_int_gos_reference")
    compare_count(got_g, "chain_int_gos")

    # the 2-D family at the JAX bench's shapes
    taps = rsp.golden.lfm_chirp(128, 0.0, 0.25)
    rd_cfg = rsp.ChainConfig(
        fft=rsp.FftConfig(max_size=SHAPE[-1]),
        matched_filter=rsp.MatchedFilterConfig(num_taps=128,
                                               fft_size=SHAPE[-1]),
        doppler=rsp.DopplerConfig(num_pulses=SHAPE[1]), cfar=cfg.cfar)
    rd_plain_cfg = dataclasses.replace(rd_cfg, cfar=plain_cfg.cfar)
    err_h = compare(krd.fused_rd_chain(x, rt, taps, rd_cfg),
                    krd.fused_rd_chain_reference(x, rt, taps, rd_cfg),
                    "rd_ca vs fused_rd_chain_reference")
    err_hm = compare_map(
        krd.fused_rd_chain(x, rt, taps, rd_cfg, emit="map"),
        krd.fused_rd_chain_reference(x, rt, taps, rd_cfg, emit="map"),
        "rd_map vs fused_rd_chain_reference(emit='map')")
    cfg2d = rsp.Cfar2dConfig(**RD2_CFG)
    rt2d = rsp.Cfar2dRuntime.make(**RD2_REGS)
    err_j = compare(krd.fused_rd_2d_chain(x, rt, rt2d, taps, rd_cfg, cfg2d),
                    krd.fused_rd_2d_chain_reference(x, rt, rt2d, taps, rd_cfg,
                                                    cfg2d),
                    "rd_2d vs fused_rd_2d_chain_reference")
    pc_cfg = pc_config(PC_SHAPE[-1])
    pc_plain_cfg = plain_of(pc_cfg)
    pgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x2 = rsp.C(*(torch.randn(PC_SHAPE, device=dev, generator=pgen) * 100
                 for _ in range(2)))
    rt_pc = rsp.RuntimeConfig.make(**PC_REGS)
    h_pc = h_planes(taps, PC_SHAPE[-1], True, dev)
    err_i = compare(kchain.pc_ca(x2, rt_pc, pc_cfg.fft, pc_cfg.cfar, h_pc),
                    kchain.pc_ca_reference(x2, rt_pc, pc_cfg.fft, pc_cfg.cfar,
                                           h_pc),
                    "pc_ca vs pc_ca_reference")
    pc_frames = pc_frame_sizes(dev, taps, samples)
    for n, (v, c, h) in pc_frames.items():
        for name, kw in (("bench", {}), ("GO grouping", dict(
                cfar_mode=1, peak_grouping=1)), ("LOG2", dict(
                mag_mode=3, log_or_linear=0, threshold_scaler=2.0))):
            rt_n = rsp.RuntimeConfig.make(**{**PC_REGS, "fft_size": n, **kw})
            compare(kchain.pc_ca(v, rt_n, c.fft, c.cfar, h),
                    kchain.pc_ca_reference(v, rt_n, c.fft, c.cfar, h),
                    f"pc_ca N {n} [{name}] vs pc_ca_reference")

    # ---- the main path through the public entry point ----
    chain = rsp.fft_mag_cfar_chain(cfg)
    plain = rsp.fft_mag_cfar_chain(plain_cfg)
    assert chain.stage_names == ("fft_mag_cfar_fused",), chain.stage_names
    assert plain.stage_names == ("fft", "logmag", "cfar"), plain.stage_names
    iq = rsp.as_pair(rsp.golden.three_tone_signal(SHAPE[-1],
                                                  shift_range_factor=12),
                     device=dev)
    launched.clear()
    for name, kw in SWEEP:
        rt_s = rsp.RuntimeConfig.make(**{**HEADLINE, **kw})
        compare(chain(x, rt_s), plain(x, rt_s), f"main path [{name}]")
    det = np.flatnonzero(chain(iq, rt).peaks.cpu().numpy())
    ca_launches = {k: launched[k] for k in ("chain_ca", "mag_cfar")}
    print(f"CA main path launches: {ca_launches}")
    print(f"three-tone detections (CA): {det.tolist()}")
    if det.tolist() != [0, 128, 256, 512]:
        raise AssertionError("three-tone detections differ from [0, 128, 256, 512]")
    if min(ca_launches.values()) < 1:
        raise AssertionError(f"a kernel of the CA path never launched: {ca_launches}")

    # ---- the default elaboration's main path ----
    gchain = rsp.fft_mag_cfar_chain()
    gplain = rsp.fft_mag_cfar_chain(gplain_cfg)
    pure_cfg = rsp.ChainConfig(cfar=rsp.CfarConfig(
        variant=rsp.CfarVariant.GOS, include_cash=False))
    pure = rsp.fft_mag_cfar_chain(pure_cfg)
    pure_plain = rsp.fft_mag_cfar_chain(plain_of(pure_cfg))
    for c in (gchain, pure):
        assert c.stage_names == ("fft_mag_gos_cfar_fused",), c.stage_names
    xs = rsp.C(x.re[:GOS_CHUNK], x.im[:GOS_CHUNK])
    launched.clear()
    for name, kw, raw, kernel in GOS_SWEEP:
        rt_s = dataclasses.replace(rsp.RuntimeConfig.make(**{**GOS_REGS, **kw}),
                                   **raw)
        before = launched[kernel]
        compare(gchain(xs, rt_s), gplain(xs, rt_s), f"default chain [{name}]")
        if launched[kernel] != before + 1:
            raise AssertionError(f"default chain [{name}] did not launch {kernel}")
    # a pure-GOS elaboration with the algorithm register left at 0 still
    # takes order statistics (it has no CA datapath)
    rt_pure = rsp.RuntimeConfig.make(**{**GOS_REGS, "cfar_algorithm": 0})
    before = launched["chain_gos"]
    compare(pure(xs, rt_pure), pure_plain(xs, rt_pure),
            "pure-GOS chain [algorithm register 0]")
    if launched["chain_gos"] != before + 1:
        raise AssertionError("the pure-GOS chain did not launch chain_gos")
    gdet = np.flatnonzero(gchain(iq, grt).peaks.cpu().numpy())
    gos_launches = dict(launched)
    print(f"default-chain main path launches: {gos_launches}; "
          f"library builds: {_build.BUILDS}")
    print(f"three-tone detections (default chain, GOS registers): "
          f"{gdet.tolist()}")
    if gdet.tolist() != [0, 128, 256, 512]:
        raise AssertionError("default-chain three-tone detections differ from "
                             "[0, 128, 256, 512]")
    if min(gos_launches.get(k, 0) for k in ("chain_ca", "mag_cfar",
                                            "mag_gos_cfar", "chain_gos")) < 1:
        raise AssertionError(f"a kernel of the default path never launched: "
                             f"{gos_launches}")

    # ---- the bit-true chains ----
    ichain = rsp.fft_mag_cfar_chain(icfg)
    iplain = rsp.fft_mag_cfar_chain(iplain_cfg)
    igchain = rsp.fft_mag_cfar_chain(igcfg)
    igplain = rsp.fft_mag_cfar_chain(igplain_cfg)
    for c in (ichain, igchain):
        assert c.stage_names == ("fft_mag_cfar_int_fused",), c.stage_names
    for c in (iplain, igplain):
        assert c.stage_names == ("fft_int", "logmag_int", "cfar_int"), \
            c.stage_names
    xis = rsp.C(xi16.re[:GOS_CHUNK], xi16.im[:GOS_CHUNK])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    full = rsp.C(*(torch.randint(-32767, 32768, xis.re.shape, device=dev,
                                 generator=gen, dtype=torch.int32)
                   for _ in range(2)))

    def sweep(path, points, run, check):
        """Drive one path over its register points with the counters set to
        0 just before and read just after; each point must launch its kernel
        once (each of its kernels, where it names a dict of launches), or no
        kernel where it names the integer ops."""
        launched.clear()
        for name, rt_s, kernel, *args in points:
            before = dict(launched)
            check(run(rt_s, *args), name, rt_s, *args)
            took = {k: v - before.get(k, 0) for k, v in launched.items()
                    if v != before.get(k, 0)}
            want = kernel if isinstance(kernel, dict) else (
                {kernel: 1} if kernel else {})
            if took != want:
                raise AssertionError(f"{path} [{name}] took {took}, not "
                                     f"{kernel or 'the integer ops'}")
        got = dict(launched)
        print(f"{path} launches: {got}")
        return got

    def int_point(name, kw, kernel):
        frames = full if name == "int SQR overflow" else xis
        return name, rsp.RuntimeConfig.make(**{**HEADLINE, **kw}), kernel, frames

    def int_check(out, name, rt_s, frames):
        compare_exact(out, iplain(frames, rt_s), f"bit-true CA chain [{name}]")
        if name == "int SQR overflow" and not bool((out.threshold < 0).any()):
            raise AssertionError("the SQR overflow point did not wrap")

    int_launches = sweep("bit-true CA path",
                         [int_point(*p) for p in INT_SWEEP],
                         lambda rt_s, frames: ichain(frames, rt_s), int_check)
    iq_int = rsp.C(iq.re.to(torch.int32), iq.im.to(torch.int32))
    idet = np.flatnonzero(ichain(iq_int, rt).peaks.cpu().numpy())
    igdet = np.flatnonzero(igchain(iq_int, grt).peaks.cpu().numpy())
    print(f"three-tone detections (bit-true CA; bit-true GOSCA, GOS "
          f"registers): {idet.tolist()}; {igdet.tolist()}")
    if idet.tolist() != [0, 128, 256, 512] or igdet.tolist() != idet.tolist():
        raise AssertionError("bit-true three-tone detections differ from "
                             "[0, 128, 256, 512]")
    int_gos_launches = sweep(
        "bit-true GOSCA path",
        [(name, dataclasses.replace(
            rsp.RuntimeConfig.make(**{**GOS_REGS, **kw}), **raw), kernel)
         for name, kw, raw, kernel in INT_GOS_SWEEP],
        lambda rt_s: igchain(xis, rt_s),
        lambda out, name, rt_s: compare_exact(
            out, igplain(xis, rt_s), f"bit-true GOSCA chain [{name}]"))

    # ---- the bit-true chains at N 2048-16384: the mid-size route ----
    # the headline's integers as frames of each of MID_SHAPES: F (the CA
    # registers on the CA elaboration) and G (the GOS registers on the GOSCA
    # + CASH one) through the chain and called directly, G also with the
    # algorithm register at 0 (F's tail in G's launch); on
    # MID_FLAGGED_FRAMES frames, stages that expand and keep the LSB, stage
    # 0 (the stage each block of N = 16384's cluster runs on both halves)
    # among them; each exact against its plain version, launching the
    # mid-size entry once
    flat = rsp.C(xi16.re.reshape(-1), xi16.im.reshape(-1))

    def frames_of(f, n):
        return rsp.C(flat.re[:f * n].reshape(f, n),
                     flat.im[:f * n].reshape(f, n))

    mid_x = {n: frames_of(f, n) for f, n in MID_SHAPES}
    mid_tops = {}
    for n in mid_x:
        for tag, top_cfg, plain_base, regs in (
                ("F", icfg, iplain_cfg, HEADLINE),
                ("G", igcfg, igplain_cfg, GOS_REGS)):
            mid_tops[tag, n] = (
                rsp.fft_mag_cfar_chain(at_size(top_cfg, n)),
                rsp.fft_mag_cfar_chain(at_size(plain_base, n)),
                rsp.RuntimeConfig.make(**{**regs, "fft_size": n}))
    mid_flags = {"F": (dict(expand=(0, 4, 9), lsb=(1, 7)), HEADLINE),
                 "G": (dict(expand=(3,), lsb=(0, 5)), GOS_REGS)}
    mid_points = []
    for n, v in mid_x.items():
        shape = f"{v.shape[0]}x{n}"
        log2n = n.bit_length() - 1
        for tag in ("F", "G"):
            top, plain_top, rt_n = mid_tops[tag, n]
            kernel = "chain_int_mid" if tag == "F" else "chain_int_gos_mid"
            what = "CA" if tag == "F" else "GOS"
            mid_points.append((f"int {what} {shape}", rt_n, kernel, top,
                               plain_top, v))
            c = at_size(icfg if tag == "F" else igcfg, n)
            fn, ref = ((kint.chain_int, kint.chain_int_reference)
                       if tag == "F" else
                       (kint.chain_int_gos, kint.chain_int_gos_reference))
            mid_points.append((
                f"{fn.__name__} {shape}, direct", rt_n, kernel,
                lambda u, r, fn=fn, c=c: fn(u, r, c.fft, c.cfar),
                lambda u, r, ref=ref, c=c: ref(u, r, c.fft, c.cfar), v))
            masks, regs = mid_flags[tag]
            fft_n = rsp.FftConfig(
                max_size=n,
                expand_logic=tuple(int(s in masks["expand"])
                                   for s in range(log2n)),
                keep_msb_or_lsb=tuple(int(s not in masks["lsb"])
                                      for s in range(log2n)))
            base_cfg, base_plain = ((icfg, iplain_cfg) if tag == "F"
                                    else (igcfg, igplain_cfg))
            mid_points.append((
                f"int {what} {MID_FLAGGED_FRAMES}x{n}, expanding "
                f"{masks['expand']}, keepLSB {masks['lsb']}", rt_n, kernel,
                *(rsp.fft_mag_cfar_chain(dataclasses.replace(
                    at_size(b, n), fft=fft_n)) for b in (base_cfg, base_plain)),
                frames_of(MID_FLAGGED_FRAMES, n)))
        gc = at_size(igcfg, n)
        rt0 = mid_tops["G", n][2].merge_regs(cfar_algorithm=0)
        mid_points.append((
            f"chain_int_gos {shape}, algorithm 0, direct", rt0,
            "chain_int_gos_mid",
            lambda u, r, c=gc: kint.chain_int_gos(u, r, c.fft, c.cfar),
            lambda u, r, c=gc: kint.chain_int_gos_reference(u, r, c.fft,
                                                            c.cfar), v))
    mid_launches = sweep(
        "bit-true path at N 2048-16384", mid_points,
        lambda rt_s, top, plain_top, v: top(v, rt_s),
        lambda out, name, rt_s, top, plain_top, v: compare_exact(
            out, plain_top(v, rt_s), f"bit-true chain [{name}]"))

    # ---- the bit-true chains beyond it: the split route ----
    # the headline's integers as frames of each of SPLIT_SHAPES, one frame of
    # SPLIT_LONG, the CA registers on the CA elaboration (F) and the GOS
    # registers on the GOSCA + CASH one (G), each through the chain and
    # exact against the plain chain (the integer ops, chunked by cells)
    split_x = {n: frames_of(f, n) for f, n in SPLIT_SHAPES}
    split_x[SPLIT_LONG] = rsp.C(*(torch.randint(
        -8000, 8001, (1, SPLIT_LONG), device=dev, generator=gen,
        dtype=torch.int32) for _ in range(2)))
    split_tops = {}
    for n in split_x:
        for tag, top_cfg, plain_base, regs in (
                ("F", icfg, iplain_cfg, HEADLINE),
                ("G", igcfg, igplain_cfg, GOS_REGS)):
            split_tops[tag, n] = (
                rsp.fft_mag_cfar_chain(at_size(top_cfg, n)),
                rsp.fft_mag_cfar_chain(at_size(plain_base, n)),
                rsp.RuntimeConfig.make(**{**regs, "fft_size": n}))
    split_points = [
        (f"int {'CA' if tag == 'F' else 'GOS'} "
         f"{split_x[n].shape[0]}x{n}", rt_n,
         "chain_int_split" if tag == "F" else "chain_int_gos_split", top,
         plain_top, split_x[n])
        for (tag, n), (top, plain_top, rt_n) in split_tops.items()]
    # stages that expand and keep the LSB in the head and in the body,
    # where the body reads its stage flags at run time
    flagged = dict(expand_logic=tuple(int(s in (1, 4, 8)) for s in range(30)),
                   keep_msb_or_lsb=tuple(int(s not in (0, 5, 12))
                                         for s in range(30)))
    for tag, n, top_cfg, plain_base, regs in (
            ("F", SPLIT_SHAPES[0][1], icfg, iplain_cfg, HEADLINE),
            ("G", 1 << 18, igcfg, igplain_cfg, GOS_REGS)):
        fft_n = rsp.FftConfig(max_size=n, **{
            k: v[:n.bit_length() - 1] for k, v in flagged.items()})
        split_points.append((
            f"int {'CA' if tag == 'F' else 'GOS'} {split_x[n].shape[0]}x{n}, "
            f"expanding 1, 4, 8, keepLSB 0, 5, 12",
            rsp.RuntimeConfig.make(**{**regs, "fft_size": n}),
            "chain_int_split" if tag == "F" else "chain_int_gos_split",
            *(rsp.fft_mag_cfar_chain(dataclasses.replace(at_size(c, n),
                                                         fft=fft_n))
              for c in (top_cfg, plain_base)),
            split_x[n]))
    split_launches = sweep(
        "bit-true path beyond N 16384", split_points,
        lambda rt_s, top, plain_top, v: top(v, rt_s),
        lambda out, name, rt_s, top, plain_top, v: compare_exact(
            out, plain_top(v, rt_s), f"bit-true chain [{name}]"))
    # the integer register sweeps at the first N
    n0 = SPLIT_SHAPES[0][1]
    xs0 = rsp.C(split_x[n0].re[:SPLIT_SWEEP_FRAMES],
                split_x[n0].im[:SPLIT_SWEEP_FRAMES])
    full0 = rsp.C(*(torch.randint(-32767, 32768, xs0.re.shape, device=dev,
                                  generator=gen, dtype=torch.int32)
                    for _ in range(2)))
    (top_f, plain_f, _), (top_g, plain_g, _) = (split_tops["F", n0],
                                                 split_tops["G", n0])
    to_split = {"chain_int": "chain_int_split",
                "chain_int_gos": "chain_int_gos_split"}

    def split_check(out, name, rt_s, top, plain_top, frames):
        compare_exact(out, plain_top(frames, rt_s),
                      f"bit-true chain N {n0} [{name}]")
        if name == "int SQR overflow" and not bool((out.threshold < 0).any()):
            raise AssertionError("the SQR overflow point did not wrap")

    split_sweep_launches = sweep(
        f"bit-true register sweeps at N {n0}",
        [(name, rsp.RuntimeConfig.make(**{**HEADLINE, "fft_size": n0, **kw}),
          to_split.get(kernel), top_f, plain_f,
          full0 if name == "int SQR overflow" else xs0)
         for name, kw, kernel in INT_SWEEP]
        + [(name, dataclasses.replace(rsp.RuntimeConfig.make(
            **{**GOS_REGS, "fft_size": n0, **kw}), **raw),
            to_split.get(kernel), top_g, plain_g, xs0)
           for name, kw, raw, kernel in INT_GOS_SWEEP],
        lambda rt_s, top, plain_top, frames: top(frames, rt_s), split_check)

    # ---- two windows a warp: the paired selection's edge points ----
    pair_edges(dev, card)

    # ---- the wire tops ----
    wchain = rsp.rx_fft_mag_cfar_tx_chain(cfg)
    wplain = rsp.rx_fft_mag_cfar_tx_chain(plain_cfg)
    iwchain = rsp.rx_fft_mag_cfar_tx_chain(icfg)
    iwplain = rsp.rx_fft_mag_cfar_tx_chain(iplain_cfg)
    igwchain = rsp.rx_fft_mag_cfar_tx_chain(igcfg)
    igwplain = rsp.rx_fft_mag_cfar_tx_chain(igplain_cfg)
    assert wchain.stage_names == ("rx_fft_mag_cfar_tx_fused",), wchain.stage_names
    assert igwchain.stage_names == ("rx_unpack", "fft_mag_cfar_int_fused",
                                    "tx_pack"), igwchain.stage_names
    ws = words[:GOS_CHUNK]

    def wire_check(out, name, rt_s, top, plain_top):
        if top is wchain:
            compare_words(out, plain_top(ws, rt_s), bw, f"wire top [{name}]")
            return
        torch.cuda.synchronize()
        if not torch.equal(out, plain_top(ws, rt_s)):
            raise AssertionError(f"wire top [{name}]: words not exact")
        print(f"wire top [{name}]: words exact")

    wire_points = [(name, rsp.RuntimeConfig.make(**{**HEADLINE, **kw}), k,
                    wchain, wplain) for name, kw, k in WIRE_SWEEP]
    wire_points += [
        ("bit-true wire CA", rt, "chain_int", iwchain, iwplain),
        ("bit-true wire GOSCA, GOS registers", grt, "chain_int_gos", igwchain,
         igwplain),
        ("bit-true wire GOSCA, CASH", grt.merge_regs(cfar_mode=3), None,
         igwchain, igwplain),
    ]
    wire_launches = sweep("wire path", wire_points,
                          lambda rt_s, top, plain_top: top(ws, rt_s),
                          wire_check)

    # ---- the range-Doppler family through its public entry points ----
    def hl(**kw):
        return rsp.RuntimeConfig.make(**{**HEADLINE, **kw})

    rd_chain = rsp.range_doppler_chain(rd_cfg, taps=taps)
    rd_plain = rsp.range_doppler_chain(rd_plain_cfg, taps=taps)
    assert rd_chain.stage_names == ("rd_fused",), rd_chain.stage_names
    assert rd_plain.stage_names == ("matched_filter", "doppler_fft", "logmag",
                                    "cfar"), rd_plain.stage_names
    rd_launches = sweep(
        "range-Doppler path",
        [(name, hl(**kw), "rd_ca") for name, kw in RD_SWEEP],
        lambda rt_s: rd_chain(x, rt_s),
        lambda out, name, rt_s: compare(out, rd_plain(x, rt_s),
                                        f"range_doppler_chain [{name}]"))
    rd_gchain = rsp.range_doppler_chain(
        dataclasses.replace(rd_cfg, cfar=gcfg.cfar), taps=taps)
    rd_gplain = rsp.range_doppler_chain(
        dataclasses.replace(rd_cfg, cfar=gplain_cfg.cfar), taps=taps)
    assert rd_gchain.stage_names == ("rd_map_fused", "mag_gos_cfar_fused"), \
        rd_gchain.stage_names
    rd_gos_launches = sweep(
        "range-Doppler GOSCA path",
        [("RD GOS registers", grt, {"rd_map": 1, "mag_gos_cfar": 1}),
         ("RD GOS CASH", grt.merge_regs(cfar_mode=3, sub_window_size=8),
          {"rd_map": 1, "mag_gos_cfar": 1}),
         ("RD GOSCA, CA registers", rt, {"rd_map": 1, "mag_cfar": 1})],
        lambda rt_s: rd_gchain(xs, rt_s),
        lambda out, name, rt_s: compare(out, rd_gplain(xs, rt_s),
                                        f"range_doppler_chain GOSCA [{name}]"))

    # the detection of a chirp target at its (Doppler, range) cell
    delay, fd = 300, 0.125
    cpi = rsp.golden.chirp_with_targets(SHAPE[1], SHAPE[2], taps,
                                        [(delay, 1.0, fd)]).astype(np.complex64)
    cell = (SHAPE[1] // 2 + int(fd * SHAPE[1]), delay)
    launched.clear()
    rt_det = hl(peak_grouping=1)
    det_out = rd_chain(cpi, rt_det)            # numpy in: to the card
    det_map = krd.fused_rd_chain(rsp.as_pair(cpi, device=dev), rt_det, taps,
                                 rd_cfg, emit="map")
    det_mag = (det_map.re ** 2 + det_map.im ** 2).cpu().numpy()
    det_launches = dict(launched)
    argmax = tuple(int(i) for i in np.unravel_index(det_mag.argmax(),
                                                    det_mag.shape))
    det_cells = np.argwhere(det_out.peaks.cpu().numpy()).tolist()
    print(f"range-Doppler detection: map maximum at {argmax}, target cell "
          f"{cell}, detected cells {det_cells[:8]} ({len(det_cells)} in all)")
    if argmax != cell or list(cell) not in det_cells:
        raise AssertionError("the chirp target is not detected at its cell")

    pc_chain = rsp.pulse_compression_chain(pc_cfg, taps=taps)
    pc_plain = rsp.pulse_compression_chain(pc_plain_cfg, taps=taps)
    assert pc_chain.stage_names == ("pc_fused",), pc_chain.stage_names
    assert pc_plain.stage_names == ("spectral_mf", "logmag", "cfar"), \
        pc_plain.stage_names
    pc_launches = sweep(
        "pulse-compression path",
        [("PC full size", rt_pc, "pc_ca"),
         ("PC GO grouping", rt_pc.merge_regs(cfar_mode=1, peak_grouping=1),
          "pc_ca"),
         ("PC SO scaler 3", rt_pc.merge_regs(cfar_mode=2,
                                             threshold_scaler=3.0), "pc_ca"),
         ("PC fft_size 2048", rt_pc.merge_regs(fft_size=2048), "mag_cfar")],
        lambda rt_s: pc_chain(x2, rt_s),
        lambda out, name, rt_s: compare(out, pc_plain(x2, rt_s),
                                        f"pulse_compression_chain [{name}]"))

    rd_wchain = rsp.rx_rd_tx_chain(rd_cfg, taps=taps)
    rd_wplain = rsp.rx_rd_tx_chain(rd_plain_cfg, taps=taps)
    assert rd_wchain.stage_names == ("rx_unpack", "rd_fused", "tx_pack"), \
        rd_wchain.stage_names
    rd_wire_launches = sweep(
        "range-Doppler wire path",
        [("RD wire CA", rt, "rd_ca"),
         ("RD wire GO grouping", hl(cfar_mode=1, peak_grouping=1), "rd_ca")],
        lambda rt_s: rd_wchain(ws, rt_s),
        lambda out, name, rt_s: compare_words(out, rd_wplain(ws, rt_s), bw,
                                              f"rx_rd_tx_chain [{name}]"))

    run2d = rsp.rd_2d_cfar_chain(rd_cfg, taps=taps, cfg2d=cfg2d)
    plain2d = rsp.rd_2d_cfar_chain(rd_plain_cfg, taps=taps, cfg2d=cfg2d)
    assert run2d.fully_fusable and not plain2d.fusable
    rd2_launches = sweep(
        "2-D detector path",
        [(name, hl(**kw), "rd_2d",
          rsp.Cfar2dRuntime.make(**{**RD2_REGS, **kw2}))
         for name, kw, kw2 in RD2_SWEEP],
        lambda rt_s, rt2_s: run2d(x, rt_s, rt2_s),
        lambda out, name, rt_s, rt2_s: compare(
            out, plain2d(x, rt_s, rt2_s), f"rd_2d_cfar_chain [{name}]"))
    far2d = rsp.Cfar2dConfig(**RD2_FAR_CFG)
    run2d_far = rsp.rd_2d_cfar_chain(rd_cfg, taps=taps, cfg2d=far2d)
    plain2d_far = rsp.rd_2d_cfar_chain(rd_plain_cfg, taps=taps, cfg2d=far2d)
    assert run2d_far.fully_fusable and not plain2d_far.fusable
    rd2_far_launches = sweep(
        "2-D detector path, long Doppler reach",
        [(name, hl(**kw), "rd_2d",
          rsp.Cfar2dRuntime.make(**{**RD2_REGS, **kw2}))
         for name, kw, kw2 in RD2_FAR_SWEEP],
        lambda rt_s, rt2_s: run2d_far(x, rt_s, rt2_s),
        lambda out, name, rt_s, rt2_s: compare(
            out, plain2d_far(x, rt_s, rt2_s), f"rd_2d_cfar_chain [{name}]"))

    # ---- the signal sources through their entry points ----
    src_launches = source_paths(dev, card, cfg, plain_cfg, gcfg, gplain_cfg,
                                sweep)

    # ---- the serving and control plane ----
    serve_launches = serving_paths(dev, card, cfg)

    # ---- the sharded chains on a mesh of virtual shards of the card ----
    from rsp_chains_tpu_torch import parallel as SP
    from rsp_chains_tpu_torch.kernels import halo as khalo
    from rsp_chains_tpu_torch.parallel.dryrun import dryrun_multichip

    scfg, rd_scfg = rdma(cfg), rdma(rd_cfg)
    rd_gscfg = rdma(dataclasses.replace(rd_cfg, cfar=gcfg.cfar))
    s_chain = rsp.fft_mag_cfar_chain(scfg)
    rd_schain = rsp.range_doppler_chain(rd_scfg, taps=taps)
    rd_gschain = rsp.range_doppler_chain(rd_gscfg, taps=taps)
    assert s_chain.stage_names == ("fft_mag_cfar_fused",)
    assert rd_gschain.stage_names == ("rd_map_fused", "mag_gos_cfar_fused")
    ext_err = 0.0

    def sharded_paths(devs, tag):
        """Drive every sharded entry point over a mesh of ``devs`` (four
        devices, repeats allowed), each path with the counters set to 0 just
        before it, each point asserting the kernels it launched, and hold it
        against the unsharded chain at the bench bar."""
        m14, m41, m22 = (SP.make_mesh(c, r, devs)
                         for c, r in ((1, 4), (4, 1), (2, 2)))
        tail = SP.range_sharded_mag_cfar(scfg, m14)
        pipe14 = SP.make_sharded_pipeline(scfg, m14)
        pipe41 = SP.make_sharded_pipeline(scfg, m41)
        rd22 = SP.make_sharded_rd_pipeline(rd_scfg, m22, taps)
        rdg22 = SP.make_sharded_rd_pipeline(rd_gscfg, m22, taps)
        on4 = {"mag_extend": 4, "mag_cfar": 4}

        def points(pts, ref, frames):
            """Each point with the unsharded chain's output on ``frames``,
            computed before the path's counters are set to 0."""
            return [(name, rt_s, k, ref(frames, rt_s)) for name, rt_s, k in pts]

        def vs(what):
            return lambda out, name, rt_s, want: compare(
                out, want, f"{what}{tag} [{name}]")

        got = {}
        got["range tail"] = sweep(
            f"range_sharded_mag_cfar 1x4{tag}", points(
                [("headline CA", rt, on4),
                 ("GO grouping", hl(cfar_mode=1, peak_grouping=1), on4),
                 ("LOG2", hl(mag_mode=3, log_or_linear=0,
                             threshold_scaler=2.0), on4),
                 ("cfar_fft_size 768", hl(cfar_fft_size=768), on4)],
                s_chain, x),
            lambda rt_s, want: tail(spec, rt_s),
            vs("range_sharded_mag_cfar 1x4"))

        def halo_check(out, name, rt_s, row):
            torch.cuda.synchronize()
            for (gl, gr), (wl, wr) in zip(
                    out, SP.exchange_halo([b.re for b in row], 128)):
                if not (torch.equal(gl, wl) and torch.equal(gr, wr)):
                    raise AssertionError(f"halo_exchange{tag}: not exact")
            print(f"halo_exchange{tag} [{name}]: exact against exchange_halo")

        row = SP.scatter(spec, m14, channels=False, ranges=True)[0]
        got["halo exchange"] = sweep(
            f"halo exchange of the 1x4 spectrum{tag}",
            [("spectrum re", rt, {"halo_exchange": 4}, row)],
            lambda rt_s, r: khalo.halo_exchange([b.re for b in r], 128),
            halo_check)
        got["pipeline 1x4"] = sweep(
            f"make_sharded_pipeline 1x4{tag}", points(
                [("headline CA", rt, on4), ("SO", hl(cfar_mode=2), on4)],
                s_chain, x),
            lambda rt_s, want: pipe14(x, rt_s),
            vs("make_sharded_pipeline 1x4"))
        got["pipeline 4x1"] = sweep(
            f"make_sharded_pipeline 4x1{tag}", points(
                [("headline CA", rt, {"chain_ca": 4}),
                 ("fft_size 512", hl(fft_size=512), {"mag_cfar": 4})],
                s_chain, x),
            lambda rt_s, want: pipe41(x, rt_s),
            vs("make_sharded_pipeline 4x1"))
        got["rd 2x2"] = sweep(
            f"make_sharded_rd_pipeline 2x2{tag}", points(
                [("RD CA", rt, {"rd_map": 2, **on4})], rd_schain, x),
            lambda rt_s, want: rd22(x, rt_s),
            vs("make_sharded_rd_pipeline 2x2"))
        gos4 = {"rd_map": 2, "mag_extend": 4, "mag_gos_cfar": 4}
        got["rd gosca 2x2"] = sweep(
            f"make_sharded_rd_pipeline 2x2, GOSCA + CASH, {GOS_CHUNK} "
            f"channels{tag}", points(
                [("RD GOS registers", grt, gos4),
                 ("RD CASH", grt.merge_regs(cfar_mode=3, sub_window_size=8),
                  gos4)], rd_gschain, xs),
            lambda rt_s, want: rdg22(xs, rt_s),
            vs("make_sharded_rd_pipeline GOSCA 2x2"))
        launched.clear()
        report = dryrun_multichip([devs[i % len(devs)] for i in range(8)])
        got["dry run"] = dict(launched)
        print(f"dry run, the five legs of dryrun_multichip{tag} (4 ch x 2 "
              f"rng, CPIs 64 x 1024, w 32): {report}; launches "
              f"{got['dry run']}")
        return got

    sharded = sharded_paths([dev] * 4, "")
    # Kernels K and L against their plain versions at the 1 x 4 mesh's
    # blocks: 16,384 frames of 256 cells, halo 128
    m14 = SP.make_mesh(1, 4, [dev] * 4)
    row = SP.scatter(spec, m14, channels=False, ranges=True)[0]
    re_row = [b.re for b in row]
    for (gl, gr), (wl, wr) in zip(khalo.halo_exchange(re_row, 128),
                                  khalo.halo_exchange_reference(re_row, 128)):
        if not (torch.equal(gl, wl) and torch.equal(gr, wr)):
            raise AssertionError("halo_exchange vs halo_exchange_reference: "
                                 "not exact")
    print("halo_exchange vs halo_exchange_reference: exact")
    for mode in (0, 1, 2, 3):
        got_ext = khalo.mag_extend(row, 128, mode)
        want_ext = khalo.mag_extend_reference(row, 128, mode)
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item()
                  for g, w in zip(got_ext, want_ext))
        scale = max(w.abs().max().item() for w in want_ext)
        print(f"mag_extend vs mag_extend_reference [mag_mode {mode}]: rel "
              f"{err / scale:.3e} (max|d| {err:.3e})")
        if not err <= 1e-6 * scale:
            raise AssertionError("mag_extend: outside 1e-6 relative")
        if mode == rt.mag_mode:
            ext_err = err
    if torch.cuda.device_count() >= 2:
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        cdevs = [cards[i % len(cards)] for i in range(4)]
        tag = f" [{len(cards)} cards]"
        sharded_paths(cdevs, tag)
        # Kernels K and L with every neighbour on another card: exact and
        # within 1e-6 as on one card; timed by the host clock over calls
        # that end in a synchronisation of every card
        crow = SP.scatter(spec, SP.make_mesh(1, 4, cdevs), channels=False,
                          ranges=True)[0]
        cre = [b.re for b in crow]
        for (gl, gr), (wl, wr) in zip(khalo.halo_exchange(cre, 128),
                                      khalo.halo_exchange_reference(cre,
                                                                    128)):
            if not (torch.equal(gl, wl) and torch.equal(gr, wr)):
                raise AssertionError(f"halo_exchange{tag}: not exact")
        for g, w in zip(khalo.mag_extend(crow, 128, rt.mag_mode),
                        khalo.mag_extend_reference(crow, 128, rt.mag_mode)):
            if not (g - w).abs().max().item() <= 1e-6 * w.abs().max().item():
                raise AssertionError(f"mag_extend{tag}: outside 1e-6")

        def sync_all():
            for c in cards:
                torch.cuda.synchronize(c)

        def host_ms(fn, calls=30):
            for _ in range(5):
                fn()
            sync_all()
            t = time.perf_counter()
            for _ in range(calls):
                fn()
            sync_all()
            return (time.perf_counter() - t) / calls * 1e3

        # the peer bytes of the busiest shard: an interior shard's two
        # neighbours' halo cells, 4 B (K) or 8 B (L) each
        peer = samples // SHAPE[-1] * 128 * 2
        for name, fn, per in (
                ("halo_exchange", lambda: khalo.halo_exchange(cre, 128), 4),
                ("mag_extend",
                 lambda: khalo.mag_extend(crow, 128, rt.mag_mode), 8)):
            print(f"{name}{tag}, 1x4 mesh over the cards, blocks 16384 x "
                  f"256, halo 128: {host_ms(fn):.4f} ms a call (host clock, "
                  f"every card synchronised); peer reads of the busiest "
                  f"shard {peer * per / 1e6:.1f} MB -> "
                  f"{peer * per / NVLINK_BYTES_PER_S * 1e3:.4f} ms at the "
                  f"peer link's rate a direction; checked against the plain "
                  f"version; card {card}")
    else:
        print("multi-card sharded phase: did not run: this host has one CUDA "
              "card; it runs when torch.cuda.device_count() >= 2")

    # ---- the pod pipeline: two processes, a time block each ----
    pod_launches = pod_paths(dev, card, cfg)

    if _build.BUILDS != 1:
        raise AssertionError(f"library built {_build.BUILDS} times, not once")
    paths = (ca_launches, gos_launches, int_launches, int_gos_launches,
             mid_launches, split_launches, split_sweep_launches,
             wire_launches, rd_launches, rd_gos_launches,
             det_launches, pc_launches, rd_wire_launches, rd2_launches,
             rd2_far_launches, *src_launches, *serve_launches,
             *sharded.values(), *pod_launches)
    launches = {k: sum(p.get(k, 0) for p in paths)
                for k in ("chain_ca", "mag_cfar", "mag_gos_cfar", "chain_gos",
                          "wire_ca", "chain_int", "chain_int_gos",
                          "chain_int_mid", "chain_int_gos_mid",
                          "chain_int_split", "chain_int_gos_split", "rd_ca",
                          "rd_map", "pc_ca", "rd_2d", "halo_exchange",
                          "mag_extend")}
    print(f"main-path launches, all paths: {launches}; library builds: "
          f"{_build.BUILDS}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel never launched on the main paths: "
                             f"{launches}")

    # ---- timing at the headline shape ----
    def chunk_ms(fn, v):
        return time_ms(lambda: chunked(fn, v), calls=10, warm=1)

    times = {
        "chain_ca": (time_ms(lambda: kchain.chain_ca(x, rt, cfg.fft, cfg.cfar)),
                     time_ms(lambda: kchain.chain_ca_reference(
                         x, rt, cfg.fft, cfg.cfar)), 13),
        "mag_cfar": (time_ms(lambda: kcfar.mag_cfar(spec, rt, cfg.cfar)),
                     time_ms(lambda: kcfar.mag_cfar_reference(
                         spec, rt, cfg.cfar)), 13),
        "fft_mag_cfar_chain": (time_ms(lambda: chain(x, rt)),
                               time_ms(lambda: plain(x, rt)), 13),
        "chain_gos": (time_ms(lambda: kchain.chain_gos(x, grt, gcfg.fft,
                                                        gcfg.cfar)),
                      chunk_ms(lambda c: kchain.chain_gos_reference(
                          c, grt, gcfg.fft, gcfg.cfar), x), 13),
        "mag_gos_cfar": (time_ms(lambda: kcfar.mag_gos_cfar(spec, grt,
                                                            gcfg.cfar)),
                         chunk_ms(lambda c: kcfar.mag_gos_cfar_reference(
                             c, grt, gcfg.cfar), spec), 13),
        "default fft_mag_cfar_chain, GOS registers": (
            time_ms(lambda: gchain(x, grt)),
            chunk_ms(lambda c: gplain(c, grt), x), 13),
        "wire_ca": (time_ms(lambda: kchain.wire_ca(words, rt, cfg.fft,
                                                    cfg.cfar)),
                    time_ms(lambda: kchain.wire_ca_reference(
                        words, rt, cfg.fft, cfg.cfar)), 8),
        "rx_fft_mag_cfar_tx_chain": (time_ms(lambda: wchain(words, rt)),
                                     time_ms(lambda: wplain(words, rt)), 8),
        "chain_int": (time_ms(lambda: kint.chain_int(xi16, rt, icfg.fft,
                                                      icfg.cfar)),
                      time_ms(lambda: kint.chain_int_reference(
                          xi16, rt, icfg.fft, icfg.cfar)), 13),
        "bit-true fft_mag_cfar_chain": (time_ms(lambda: ichain(xi16, rt)),
                                        time_ms(lambda: iplain(xi16, rt)), 13),
        "chain_int_gos": (time_ms(lambda: kint.chain_int_gos(
            xi16, grt, igcfg.fft, igcfg.cfar)),
            chunk_ms(lambda c: kint.chain_int_gos_reference(
                c, grt, igcfg.fft, igcfg.cfar), xi16), 13),
        "bit-true GOSCA fft_mag_cfar_chain, GOS registers": (
            time_ms(lambda: igchain(xi16, grt)),
            chunk_ms(lambda c: igplain(c, grt), xi16), 13),
        "rd_ca": (time_ms(lambda: krd.fused_rd_chain(x, rt, taps, rd_cfg)),
                  time_ms(lambda: krd.fused_rd_chain_reference(
                      x, rt, taps, rd_cfg)), 13),
        "rd_map": (time_ms(lambda: krd.fused_rd_chain(x, rt, taps, rd_cfg,
                                                      emit="map")),
                   time_ms(lambda: krd.fused_rd_chain_reference(
                       x, rt, taps, rd_cfg, emit="map")), 16),
        "range_doppler_chain": (time_ms(lambda: rd_chain(x, rt)),
                                time_ms(lambda: rd_plain(x, rt)), 13),
        "rd_2d": (time_ms(lambda: krd.fused_rd_2d_chain(x, rt, rt2d, taps,
                                                        rd_cfg, cfg2d)),
                  time_ms(lambda: krd.fused_rd_2d_chain_reference(
                      x, rt, rt2d, taps, rd_cfg, cfg2d)), 13),
        "rd_2d_cfar_chain": (time_ms(lambda: run2d(x, rt, rt2d)),
                             time_ms(lambda: plain2d(x, rt, rt2d)), 13),
        "pc_ca": (time_ms(lambda: kchain.pc_ca(x2, rt_pc, pc_cfg.fft,
                                               pc_cfg.cfar, h_pc)),
                  time_ms(lambda: kchain.pc_ca_reference(
                      x2, rt_pc, pc_cfg.fft, pc_cfg.cfar, h_pc)), 13),
        "pulse_compression_chain": (time_ms(lambda: pc_chain(x2, rt_pc)),
                                    time_ms(lambda: pc_plain(x2, rt_pc)), 13),
    }
    # the sharded tail at the 1 x 4 mesh, on placed blocks: Kernel L, then
    # Kernel B on the given magnitude, and the whole step
    tail14 = SP.range_sharded_mag_cfar(scfg, m14)
    placed = [row]
    exts = khalo.mag_extend(row, 128, rt.mag_mode)
    halo_times = {
        "halo_exchange": (time_ms(lambda: khalo.halo_exchange(re_row, 128)),
                          time_ms(lambda: khalo.halo_exchange_reference(
                              re_row, 128))),
        "mag_extend": (time_ms(lambda: khalo.mag_extend(row, 128,
                                                         rt.mag_mode)),
                       time_ms(lambda: khalo.mag_extend_reference(
                           row, 128, rt.mag_mode))),
    }
    tail_split = {
        "mag_extend, 4 shards": halo_times["mag_extend"][0],
        "mag_cfar on the given magnitude, 4 shards": time_ms(lambda: [
            kcfar.mag_cfar(e, rt, scfg.cfar, active_lo=lo, active_hi=hi,
                           mag_given=True)
            for e, (lo, hi) in zip(exts, ((128, 512), (0, 512), (0, 512),
                                          (0, 384)))]),
        "range_sharded_mag_cfar 1x4, placed blocks": time_ms(
            lambda: tail14(placed, rt)),
        "range_sharded_mag_cfar 1x4, from the global spectrum": time_ms(
            lambda: tail14(spec, rt)),
        "make_sharded_pipeline 1x4": time_ms(
            lambda: SP.make_sharded_pipeline(scfg, m14)(x, rt)),
        "make_sharded_pipeline 4x1": time_ms(
            lambda: SP.make_sharded_pipeline(scfg, SP.make_mesh(
                4, 1, [dev] * 4))(x, rt)),
        "make_sharded_rd_pipeline 2x2": time_ms(
            lambda: SP.make_sharded_rd_pipeline(rd_scfg, SP.make_mesh(
                2, 2, [dev] * 4), taps)(x, rt), calls=10),
    }
    for name, ms in tail_split.items():
        print(f"sharded: {name}: {ms:.4f} ms at {'x'.join(map(str, SHAPE))}; "
              f"card {card}")
    for name, (ms, plain_ms) in halo_times.items():
        print(f"{name}, 1x4 mesh of 16384 x 256 blocks, halo 128: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms; card {card}")
    assert x2.re.numel() == samples
    print(f"plain GOS times are of the {SHAPE[0]} channels in "
          f"{GOS_CHUNK}-channel chunks")
    for name, (ms, plain_ms, per) in times.items():
        shape = PC_SHAPE if name in ("pc_ca", "pulse_compression_chain") \
            else SHAPE
        print(f"{name} at {'x'.join(map(str, shape))}: kernel path {ms:.4f} ms "
              f"= {samples / ms / 1e3:.1f} Msamples/s "
              f"({per * samples / ms / 1e6:.1f} GB/s of {per} B/sample); "
              f"plain path {plain_ms:.4f} ms = "
              f"{samples / plain_ms / 1e3:.1f} Msamples/s; card {card}")

    # ---- Kernel B at its points and frame sizes, Kernel I at its sizes ----
    # (and the split route of F and G at SPLIT_SHAPES)
    tails = tail_times(dev)
    print_tail_times(tails, card)

    # ---- Kernels F and G at N 2048-16384: the mid-size route ----
    # each kernel on the card alone (tail_times' at MID_SHAPES, on the same
    # frames), its chain by events, its plain version over 5 calls
    mid_times = {}
    for (tag, n), (top, plain_top, rt_n) in mid_tops.items():
        v = mid_x[n]
        c = at_size(icfg if tag == "F" else igcfg, n)
        name, fn, ref = (
            ("chain_int_mid", kint.chain_int, kint.chain_int_reference)
            if tag == "F" else ("chain_int_gos_mid", kint.chain_int_gos,
                                kint.chain_int_gos_reference))
        shape = "x".join(map(str, v.shape))
        ms = tails[mid_label(fn.__name__, v.shape[0], n)][1]
        chain_ms = time_ms(lambda: top(v, rt_n))
        plain_ms = time_ms(lambda: ref(v, rt_n, c.fft, c.cfar), calls=5,
                           warm=1)
        mid_times[name, n] = (ms, plain_ms)
        print(f"{name} at {shape}: kernel {ms:.4f} ms on the card alone = "
              f"{v.re.numel() / ms / 1e3:.1f} Msamples/s, through "
              f"fft_mag_cfar_chain {chain_ms:.4f} ms, plain {plain_ms:.4f} ms; "
              f"card {card}")

    # ---- Kernels F and G beyond N 16384: the split route ----
    # each kernel by CUDA events (tail_times' at SPLIT_SHAPES, on the same
    # frames), its chain too, its plain version over 5 calls; the profile
    # splits a call into its head, body and tail launches
    split_times = {}
    for (tag, n), (top, plain_top, rt_n) in split_tops.items():
        v = split_x[n]
        c = at_size(icfg if tag == "F" else igcfg, n)
        name, fn, ref = (
            ("chain_int_split", kint.chain_int, kint.chain_int_reference)
            if tag == "F" else ("chain_int_gos_split", kint.chain_int_gos,
                                kint.chain_int_gos_reference))
        shape = "x".join(map(str, v.shape))
        label = (f"{name} at {shape}, "
                 f"{'headline' if tag == 'F' else 'GOS'} registers")
        ms = (tails[label][0] if label in tails
              else time_ms(lambda: fn(v, rt_n, c.fft, c.cfar)))
        chain_ms = time_ms(lambda: top(v, rt_n))
        plain_ms = time_ms(lambda: ref(v, rt_n, c.fft, c.cfar), calls=5,
                           warm=1)
        split_times[name, n] = (ms, plain_ms)
        print(f"{name} at {shape}: kernel {ms:.4f} ms = "
              f"{v.re.numel() / ms / 1e3:.1f} Msamples/s, through "
              f"fft_mag_cfar_chain {chain_ms:.4f} ms, plain {plain_ms:.4f} ms; "
              f"card {card}")
        if n == SPLIT_SHAPES[0][1]:
            profile(lambda: fn(v, rt_n, c.fft, c.cfar), f"{name} at {shape}",
                    ())

    # ---- Kernel F's routes on the headline's samples ----
    # the row plan (N 1024), the mid-size route (2048-16384) and the split
    # route (32768) over the same integers, at the bench's stage flags and at
    # seven expanding stages, where the stages read their flags at run time;
    # each flagged call exact against its plain version
    for n in (SHAPE[-1],) + tuple(n for _, n in MID_SHAPES) + (
            SPLIT_SHAPES[0][1],):
        v = frames_of(samples // n, n)
        c = at_size(icfg, n)
        rt_n = rt.merge_regs(fft_size=n)
        wide = rsp.FftConfig(max_size=n, expand_logic=tuple(
            int(s < 7) for s in range(n.bit_length() - 1)))
        compare_exact(kint.chain_int(v, rt_n, wide, c.cfar),
                      kint.chain_int_reference(v, rt_n, wide, c.cfar),
                      f"chain_int at N {n}, 7 expanding stages")
        plain_flags, wide_ms = (
            device_ms(lambda f=f: kint.chain_int(v, rt_n, f, c.cfar))
            for f in (c.fft, wide))
        print(f"chain_int at {v.shape[0]}x{n}, on the card alone: bench stage "
              f"flags {plain_flags:.4f} ms, 7 expanding stages {wide_ms:.4f} "
              f"ms; card {card}")

    # ---- the rank selection of Kernels C, D and G on its own ----
    # each kernel at the GOS registers over the windows of SEL_WINDOWS, and
    # at each window with the algorithm register at 0, where the CA sums
    # take the selection's place (tail_times, on the card alone): the
    # difference is the selection's time. Kernel C at w <= 32 runs its
    # selection two frames a block and its CA sums one frame a block (two
    # instantiations), so there the difference also holds the change of
    # block layout and occupancy.
    for w, g in SEL_WINDOWS:
        for name in ("chain_gos", "mag_gos_cfar", "chain_int_gos"):
            ms1, ms0 = (tails[sel_label(name, w, g, a)][1] for a in (1, 0))
            what = ("the difference (two frames a block against one)"
                    if name == "mag_gos_cfar" and w <= 32 else "the selection")
            print(f"{name} at w {w} g {g} ranks {w // 2}/{w // 2}, "
                  f"{'x'.join(map(str, SHAPE))}, on the card alone: "
                  f"{ms1:.4f} ms; algorithm 0 (CA sums) {ms0:.4f} ms; "
                  f"{what} {ms1 - ms0:.4f} ms; card {card}")
    for name, (regs, st, ld, stack) in ptxas_report(
            _build.build_log(), ("rsp_chain_ca_rows_kernel",
                                 "rsp_wire_ca_rows_kernel",
                                 "rsp_int_split_head_kernel",
                                 "rsp_int_split_body_kernel",
                                 "rsp_int_split_tail_kernel",
                                 "rsp_pc_ca_rows_kernel",
                                 "rsp_mag_cfar_kernel",
                                 "rsp_chain_int_rows_kernel",
                                 "rsp_chain_gos_rows_kernel",
                                 "rsp_mag_gos_cfar_kernel",
                                 "rsp_chain_int_gos_rows_kernel",
                                 "rsp_int_mid_kernel",
                                 "rsp_rd_rows_kernel",
                                 "rsp_rd_doppler_kernel",
                                 "rsp_cfar2d_kernel")).items():
        print(f"ptxas -v {name}: {regs} registers, {st} B spill stores, "
              f"{ld} B spill loads, {stack} B stack frame")

    # ---- the row kernels of A, D, E, F, G, I and B at 1-4 blocks an SM ----
    row_blocks(card, x, xi16, spec, rt, cfg, x2, rt_pc, pc_cfg, h_pc, words,
               grt, gcfg, igcfg)

    # ---- a yardstick for the range rows' FFT pair (never on the path) ----
    rows = torch.complex(x.re, x.im).reshape(-1, SHAPE[-1])
    fft_pair_ms = time_ms(lambda: torch.fft.ifft(torch.fft.fft(rows)))
    print(f"yardstick: torch.fft.fft + torch.fft.ifft over {rows.shape[0]} "
          f"rows of {SHAPE[-1]} (complex64): {fft_pair_ms:.4f} ms; card "
          f"{card}")
    # ---- a yardstick for the Doppler launch: one FFT over the pulses of the
    # same planes (never on the path) ----
    cpis = torch.complex(x.re, x.im)
    dop_ms = time_ms(lambda: torch.fft.fft(cpis, dim=-2))
    print(f"yardstick: torch.fft.fft over the {SHAPE[1]} pulses of "
          f"{'x'.join(map(str, SHAPE))} (complex64): {dop_ms:.4f} ms; card "
          f"{card}")

    # ---- bounds: bytes over the memory rate, least work over the rates ----
    frames_n = samples // SHAPE[-1]
    fft_ops = frames_n * 5 * SHAPE[-1] * bw
    int_fft_ops = frames_n * SHAPE[-1] // 2 * bw * INT_BUTTERFLY_OPS
    log2w, guard = window_registers(grt, gcfg.cfar)
    w = 1 << log2w
    starts = np.arange(-guard - w, SHAPE[-1] + guard + 1)
    n_act = min(grt.cfar_fft_size, SHAPE[-1])
    nv = np.clip(np.minimum(starts + w, n_act) - np.maximum(starts, 0), 0, None)
    # a sorted window sliding one cell a start: a deletion and an insertion,
    # each a binary search of ceil(log2(w + 1)) compares; both ranks read off
    sel_least = frames_n * 2 * w.bit_length() * int((nv > 0).sum())
    print(f"rank selection, {SHAPE[0]}x{SHAPE[1]} frames: least work "
          f"{sel_least:.4e} compares -> {sel_least / CMP_PER_S * 1e3:.4f} ms")
    # (bytes a sample, fp32 operations, int32 operations, compares)
    work = {"chain_ca": (13, fft_ops, 0, 0), "mag_cfar": (13, 0, 0, 0),
            "mag_gos_cfar": (13, 0, 0, sel_least),
            "chain_gos": (13, fft_ops, 0, sel_least),
            "wire_ca": (8, fft_ops, 0, 0), "chain_int": (13, 0, int_fft_ops, 0),
            "chain_int_gos": (13, 0, int_fft_ops, sel_least)}
    # the range-Doppler front: two FFTs along range a pulse and one along the
    # pulses a range column; pulse compression: one FFT a frame
    p_log2 = SHAPE[1].bit_length() - 1
    rd_ops = (frames_n * 2 * 5 * SHAPE[-1] * bw
              + SHAPE[0] * SHAPE[-1] * 5 * SHAPE[1] * p_log2)
    pc_ops = (samples // PC_SHAPE[-1]) * 5 * PC_SHAPE[-1] * (
        PC_SHAPE[-1].bit_length() - 1)
    work.update({"rd_ca": (13, rd_ops, 0, 0), "rd_map": (16, rd_ops, 0, 0),
                 "pc_ca": (13, pc_ops, 0, 0), "rd_2d": (13, rd_ops, 0, 0)})
    # the range-Doppler launches on their own: the Doppler launch 8 bytes a
    # sample in and 8 out; the range rows 8 in and 5 (CA), 8 (map) or 4
    # (magnitude) out; J's detector the magnitude in, 4 + 1 out
    for name, per in (("Doppler launch", 16), ("range rows, CA", 13),
                      ("range rows, map", 16), ("range rows, magnitude", 12),
                      ("2-D detector", 9)):
        print(f"bound {name}: {per} B/sample -> "
              f"{per * samples / HBM_BYTES_PER_S * 1e3:.4f} ms")
    # Kernels K and L move bytes only (a dozen flops a cell): each shard
    # reads its neighbours' halo cells and writes both halos (K); reads its
    # block and the halo cells and writes the extended row (L)
    frames_l = samples // SHAPE[-1]
    n_loc, halo_w, n_sh = SHAPE[-1] // 4, 128, 4
    nb_reads = 2 * (n_sh - 1)
    halo_bytes = {
        "halo_exchange": frames_l * halo_w * 4 * (nb_reads + 2 * n_sh),
        "mag_extend": frames_l * (n_sh * n_loc * 8 + nb_reads * halo_w * 8
                                  + n_sh * (n_loc + 2 * halo_w) * 4),
    }
    bounds = {}
    for name, nbytes in halo_bytes.items():
        bounds[name] = (nbytes / HBM_BYTES_PER_S * 1e3, "bytes")
        print(f"bound {name}: {nbytes / 1e6:.1f} MB over the 4 shards -> "
              f"{bounds[name][0]:.4f} ms")
    # the mid-size and split routes at each size: the function's 13 bytes a
    # sample, the butterflies of its N/2 log2 N a frame, G's selection over
    # its windows
    for (name, n), _ in (*mid_times.items(), *split_times.items()):
        v, rt_n = ((mid_x[n], mid_tops["G" if "gos" in name else "F", n][2])
                   if name.endswith("_mid") else
                   (split_x[n], split_tops["G" if "gos" in name else "F",
                                           n][2]))
        frames_s, log2n = v.shape[0], n.bit_length() - 1
        cmp = 0
        if "gos" in name:
            lw, gd = window_registers(rt_n, igcfg.cfar)
            st = np.arange(-gd - (1 << lw), n + gd + 1)
            act = min(rt_n.cfar_fft_size, n)
            nvs = np.clip(np.minimum(st + (1 << lw), act) - np.maximum(st, 0),
                          0, None)
            cmp = frames_s * 2 * (1 << lw).bit_length() * int((nvs > 0).sum())
        work[name, n] = (13, 0, frames_s * n // 2 * log2n * INT_BUTTERFLY_OPS,
                         cmp, frames_s * n)
    for name, (per, f32, i32, cmp, *size) in work.items():
        samples_w = size[0] if size else samples
        byte_ms = per * samples_w / HBM_BYTES_PER_S * 1e3
        ops_ms = (f32 / FP32_OPS_PER_S + i32 / INT_OPS_PER_S
                  + cmp / CMP_PER_S) * 1e3
        bounds[name] = (max(byte_ms, ops_ms),
                        "bytes" if byte_ms >= ops_ms else "operations")
        label = name if isinstance(name, str) else f"{name[0]} at N {name[1]}"
        print(f"bound {label}: {per} B/sample -> {byte_ms:.4f} ms; "
              f"{f32:.4e} fp32 + {i32:.4e} int32 operations + {cmp:.4e} "
              f"compares -> {ops_ms:.4f} ms")

    # ---- where the time goes ----
    small = rt.merge_regs(fft_size=512)
    profile(lambda: chain(x, rt), "kernel path, full size",
            chain.stage_names)
    profile(lambda: plain(x, rt), "plain path, full size", plain.stage_names)
    profile(lambda: chain(x, small), "kernel path, fft_size 512",
            chain.stage_names)
    profile(lambda: gchain(x, grt), "default chain, GOS registers",
            gchain.stage_names)
    profile(lambda: igchain(xi16, grt), "bit-true GOSCA chain, GOS registers",
            igchain.stage_names)
    # Kernels D and G at their smaller frames: the launches' names
    for n in (256, 512):
        xn, xin = (rsp.C(v.re.reshape(-1, n), v.im.reshape(-1, n))
                   for v in (x, xi16))
        rt_n = grt.merge_regs(fft_size=n)
        for name, fn, c, v in (("chain_gos", kchain.chain_gos, gcfg, xn),
                               ("chain_int_gos", kint.chain_int_gos, igcfg,
                                xin)):
            profile(lambda fn=fn, c=at_size(c, n), v=v: fn(v, rt_n, c.fft,
                                                           c.cfar),
                    f"{name} at {v.shape[0]}x{n}, GOS registers", (),
                    calls=5, top=1)
    profile(lambda: rd_chain(x, rt), "range-Doppler kernel path",
            rd_chain.stage_names)
    profile(lambda: krd.fused_rd_chain(x, rt, taps, rd_cfg, emit="map"),
            "range-Doppler map (rd_map)", ())
    profile(lambda: rd_plain(x, rt), "range-Doppler plain path",
            rd_plain.stage_names)
    profile(lambda: run2d(x, rt, rt2d), "2-D detector kernel path", ())
    launch_split(lambda: run2d(x, rt, rt2d), "2-D detector kernel path")
    launch_split(lambda: rd_chain(x, rt), "range-Doppler kernel path")
    profile(lambda: tail14(placed, rt), "range-sharded tail 1x4, placed", ())
    profile(lambda: khalo.halo_exchange(re_row, 128), "halo_exchange 1x4", ())

    n0_split, n_mid = SPLIT_SHAPES[0][1], MID_SHAPES[-1][1]
    for name in ("chain_int_split", "chain_int_gos_split"):
        times[name] = (*split_times[name, n0_split], None)
        bounds[name] = bounds[name, n0_split]
    for name in ("chain_int_mid", "chain_int_gos_mid"):
        times[name] = (*mid_times[name, n_mid], None)
        bounds[name] = bounds[name, n_mid]
    errs = {"chain_int_split": 0.0, "chain_int_gos_split": 0.0,
            "chain_int_mid": 0.0, "chain_int_gos_mid": 0.0,
            "chain_ca": err_a, "mag_cfar": err_b, "mag_gos_cfar": err_c,
            "chain_gos": err_d, "wire_ca": err_e, "chain_int": err_f,
            "chain_int_gos": err_g, "rd_ca": err_h, "rd_map": err_hm,
            "pc_ca": err_i, "rd_2d": err_j, "halo_exchange": 0.0,
            "mag_extend": ext_err}
    times.update({k: (*v, None) for k, v in halo_times.items()})
    sources = {
        "chain_ca": ("chain_ca.cu", "rsp_chains_tpu/kernels/chain_pallas.py:841"),
        "mag_cfar": ("mag_cfar.cu", "rsp_chains_tpu/kernels/cfar_pallas.py:489"),
        "mag_gos_cfar": ("mag_gos_cfar.cu",
                         "rsp_chains_tpu/kernels/cfar_pallas.py:1593"),
        "chain_gos": ("chain_gos.cu",
                      "rsp_chains_tpu/kernels/chain_pallas.py:1221"),
        "wire_ca": ("wire_ca.cu", "rsp_chains_tpu/kernels/chain_pallas.py:1042"),
        "chain_int": ("chain_int.cu",
                      "rsp_chains_tpu/kernels/int_chain_pallas.py:441"),
        "chain_int_gos": ("chain_int_gos.cu",
                          "rsp_chains_tpu/kernels/int_chain_pallas.py:552"),
        "chain_int_mid": ("int_mid.cu",
                          "rsp_chains_tpu/kernels/int_chain_pallas.py:441"),
        "chain_int_gos_mid": (
            "int_mid.cu", "rsp_chains_tpu/kernels/int_chain_pallas.py:552"),
        "chain_int_split": ("int_split.cu",
                            "rsp_chains_tpu/kernels/int_chain_pallas.py:441"),
        "chain_int_gos_split": (
            "int_split.cu", "rsp_chains_tpu/kernels/int_chain_pallas.py:552"),
        "rd_ca": ("rd_ca.cu", "rsp_chains_tpu/kernels/rd_pallas.py:565"),
        "rd_map": ("rd_ca.cu", "rsp_chains_tpu/kernels/rd_pallas.py:565"),
        "pc_ca": ("pc_ca.cu", "rsp_chains_tpu/kernels/chain_pallas.py:863"),
        "rd_2d": ("rd_2d.cu", "rsp_chains_tpu/kernels/rd_pallas.py:442"),
        "halo_exchange": ("halo.cu",
                          "rsp_chains_tpu/kernels/pallas_halo.py:124"),
        "mag_extend": ("halo.cu", "rsp_chains_tpu/kernels/pallas_halo.py:177"),
    }
    # no one PyTorch call computes FFT (or matched filter and Doppler
    # transform) + magnitude + CFAR, the neighbours' halos with zeros at the
    # frame ends, or the extended magnitude row, so library_ms is null for
    # every kernel
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"rsp_chains_tpu_torch/csrc/{src}", "replaces": replaces,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None}
        for name, (src, replaces) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
