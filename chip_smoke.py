#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (openair4g_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit, torch and CUDA versions;
  2. build the hand-written kernels from openair4g_tpu_torch/csrc/ for
     sm_90a into build/kernels/ (one nvcc call), with ptxas's register
     report;
  3. the v2 turbo kernel and mrc_llr against their plain PyTorch versions
     on the card at the 20 MHz flagship shapes (the PDCCH's n0 a number,
     which goes in as a kernel argument; max |diff| against the
     stated tolerance, time of each by CUDA events over back-to-back
     calls; the device time comes in phase 16). The v2 kernel keeps
     one beta checkpoint per 8 trellis nodes in an L2-sized scratch and
     recomputes each block's betas from it, with float4 loads and stores;
     it must equal its plain version bit for bit. The phase prints that
     scratch's bytes and the peak device memory of the kernel's call and
     of the phase;
  4. the small-input check: 25 PRB round 0 on the card (kernels) and on
     the CPU (plain versions) with the same injected draws must agree;
  5. the flagship: DlsimFading round 0, 100 PRB MCS 26, EVA, joint
     estimation, batch 128, 8 turbo iterations, drawn on the card. At
     26 dB every TB and every DCI must decode; at 24 dB TBs must decode
     and BLER and subframes/s are printed. Both its kernels' launch counts
     over these runs must be non-zero;
  6. demap_llr against its plain version on the card at the multi-antenna
     paths' shapes, one layer of an MMSE output read in place;
  7. the v1 turbo kernel against its plain version and the v2 kernel at
     the flagship shapes; no path runs v1, so its launch count is that of
     its timed run. It keeps beta checkpoints as v2 does and reads lin
     where it lies: the phase prints the call's measured scratch, fails
     above 45 MB, and checks that each call adds one to the wrapper's
     launch count (phase 16 counts the device kernels of one call);
  8. small inputs of the multi-antenna simulators (TM2, TM3, TM4, TM5 IA,
     TM6; 25 PRB, batch 4, 30 dB), card against CPU on the same injected
     draws: TB flags, DCI flags and bit errors must be equal;
  9. TM2 at the fidelity corpus configuration (50 PRB, MCS 25, EVA, 2x2,
     estimated channel, batch 128), 2048 trials at 14 and 15 dB, held to
     the corpus anchor fidelity_campaign.json "txdiv64";
 10. TM3 at full width (100 PRB, MCS 26/26, 2x2, batch 64): at 40 dB every
     DCI decodes and each codeword's BLER over 10 steps is at most 0.2;
 11. mrc_llr at A = 2 against its plain version at the 1x2 path's shapes
     (100 PRB, CFI 2, batch 128: data Qm = 6 with per-RE n0, PDCCH Qm = 2
     with n0 a number), interleaved [B, N, 2] and as the path gives them,
     [B, 2, N] antenna planes passed as transposed views and read where
     they lie: the two must be equal;
 12. small inputs of DlsimFading (25 PRB, batch 4, 30 dB: dd 1x2 over 4
     HARQ rounds, interp on AWGN, the time-domain ETU channel, EVA at
     200 Hz, the AR(1) fade over 2 rounds, perfect CE 1x2) and DlsimAwgn,
     card against CPU on the same draws: every round's TB flags, DCI flags
     and bit errors must be equal;
 13. the corpus receiver at full width: DlsimFading 100 PRB, MCS 26, EVA,
     1x2 MRC, dd, CFI 2, 4 HARQ rounds, dlsim SNR convention, batch 128,
     8 steps at 14.6 dB: round-0 BLER in [0.02, 0.98], fewer errors in
     round 1 than 0, at most 1 % DCI misses, both kernels launched;
 14. the SISO fidelity anchors of tests/test_bler_anchor.py and
     tests/test_fading.py, fading corpus tests 6 and 11 and the Doppler
     corpus point, with the reference's configurations, trial counts and
     bands (the JAX anchors were taken on a TPU);
 15. DlsimAwgn at bench.py's second configuration (BLER at most 0.01 at
     1 dB) and the dlsim command line on the card (-g EVA -r 4, -x 2),
     each writing a reference-schema CSV under build/;
 17. the v2 turbo kernel at the full-width uplink shape (1,024 x 5,760)
     against its plain version: equal bit for bit;
 18. small uplink inputs (Ulsim, batch 8) in every mode of the uplink
     tests (data only over 2 HARQ rounds, UCI on the Reed-Muller and on
     the convolutional path, type-1 and type-2 frequency hopping, the
     time-domain FIR channel, the genie channel with hopping), card
     against CPU on the same draws: every round's flags, errs, reach and
     UCI error counts must be equal;
 19. the full-width uplink: Ulsim 100 PRB, MCS 20, EVA, estimated DMRS
     channel, 4 HARQ rounds, batch 128, UCI of 30 CQI bits, RI and 2 ACK
     bits; at 30 dB every TB and UCI field decodes, at UL_MID_SNR round 0
     fails for 20-80 % of the TBs and round 1 for fewer; step time, TB
     trials/s and the v2 kernel's launches in one step;
 20. the uplink ladder anchors of tests/test_bler_anchor.py in their
     bands, and four ulsim_campaign.json points beside the port's BLER
     over 2,048 trials;
 21. Pucchsim at the operating points of tests/test_pucch.py, card
     against CPU on the same draws, and the pucchsim command line;
 22. small inputs of the control and sync simulators (Pdcchsim, Pbchsim,
     Syncsim with and without CFO, CarrierScan, Prachsim RE-level,
     restricted, format 4 and time-domain, Mbmssim with estimated CE; 25
     PRB), card against CPU on the same draws: every decision and error
     count equal, CFO estimates within 1e-3 subcarrier spacings;
 23. the v2 turbo kernel at the MBSFN full-width shape (1,024 x 6,000)
     against its plain version: equal bit for bit;
 24. Mbmssim at full width: 100 PRB extended CP, MCS 22, 3 SFN cells with
     delays to 0.8 of the CP, 8 iterations, batch 128. With the channel
     known every TB decodes at MBMS_HIGH_SNR and BLER is in [0.05, 0.5]
     at MBMS_MID_SNR; with the MBSFN RS estimate the reference's BLER
     floor holds at MBMS_HIGH_SNR; step times, TB trials/s and the v2
     kernel's launches in one step;
 25. the reference's control and sync anchors: tests/test_pbch_pdcch_anchor
     .py (PBCH 25 PRB; PDCCH 100 PRB CFI 2 L = 4 and 8), the cell-search
     and CFO points of tests/test_sync_pbch.py, prach_roc.json's four
     configurations at threshold 15 within 3 sd, tests/test_mbms.py's two
     link points;
 26. Syncsim and CarrierScan at 100 PRB and the time-domain Prachsim at
     n_fft 2048, n_rb_ul 100: detection rates and step times;
 27. this slice's paths at small size (25 PRB, batch 4, 30 dB unless
     noted), card against CPU on the same injected draws: FullChainSim
     on AWGN and EVA over 4 rounds (every round's TB, DCI and PHICH flags
     and the counts), UeRx.receive with TM 2 (both size hypotheses),
     EnbRx.receive_pusch with an SRS and receive_pucch, UlGrantSim over 2
     rounds, a TddFrameSim frame at 6 PRB, cold start: all equal;
 28. mrc_llr at A = 1 at the PCFICH [128, 16], FullChainSim's PDCCH
     [128, 3,168], its MCS 4 PDSCH [32, 12,600] (Qm 2) and its MCS 26
     PDSCH [128, 12,600] (Qm 6), n0 a number, within rtol = atol = 3e-4
     of its plain version, timed over a ring of input copies twice the
     L2's size; v2 at FullChainSim's MCS 4 shape (64 x 3,840) bit-exact;
 29. FullChainSim at the flagship load (100 PRB, MCS 26, EVA, 4 HARQ
     rounds, 8 iterations, batch 128): every TB and DCI at FULL_HIGH_SNR;
     near FULL_MID_SNR round-0 BLER in [0.02, 0.98], fewer errors in
     round 1, at most 1 % DCI misses, mrc_llr twice a round; TB trials/s;
 30. FullChainSim's defaults at 6 dB (every TB in round 0, no DCI miss,
     no PHICH error), cold start at 100 PRB, fullsim_main writing the
     reference's CSV, generate_frame at 100 PRB against its CPU run;
 31. UlGrantSim (96 PRB granted at MCS 20, 4 rounds, batch 128) with the
     DL at 20 and -30 dB, and TddFrameSim configuration 1 at 100 PRB;
 32. the reference's anchors of this slice with its configurations,
     trial counts and assertions (tests/test_fullsim.py,
     tests/test_sched_ul.py, tests/test_tddsim.py);
 33. every other (kernel, shape) that phases 29-31 launched (each wrapper
     counts its launches by shape too), against its plain version on
     random inputs of that shape: the flagship load's v2 at 1,408 x 5,760
     and mrc_llr at Qm 6, UlGrantSim's and TddFrameSim's codecs, the TDD
     frame's PCFICH, PDCCH and PDSCH; only v2 and mrc_llr may launch;
 34. the system emulator at small size (6 PRB), card against CPU on the
     same draws (the CPU sim's, kept by TTI): Oaisim in the abstraction
     mode with EESM, PF and 4 HARQ rounds, with MIESM, TDD, UL traffic
     and 4 rounds, and the handover walk of tests/test_handover.py;
     in the full-PHY mode with 2 eNBs and 4 UEs on AWGN and EPA over 2
     frames with 4 rounds (decoder window 240 on both sides): every
     per-TTI error flag, every stats array, summary() and the pcap bytes
     equal, and every abstraction coin flip more than 1e-5 from its BLER;
 35. the v2 turbo kernel at the full-PHY oaisim shape (640 x 6,240: 128
     UEs x 5 blocks of K = 6,144) against its plain version: equal bit
     for bit;
 36. the full-PHY Oaisim at full width (3 eNBs 500 m apart, 128 static
     UEs, 100 PRB, MCS 16, EPA, 4 HARQ rounds, 6 iterations, full buffer,
     round robin, TX power 60 dB, 4 frames): every eNB schedules every
     TTI, no UE at a geometry SINR of 20 dB or more loses a TB, v2
     launches on every TTI and at 640 x 6,240 only; mean BLER,
     retransmissions, throughput and ms a TTI; then 1 eNB at 70 dB loses
     no TB and retransmits none;
 37. the abstraction Oaisim at full width (7 eNBs, 1,024 UEs, 100 PRB,
     MCS 16, EPA, 4 HARQ rounds, UL traffic, TX power 60 dB, 20 frames),
     with EESM and with MIESM: every eNB schedules every TTI, no kernel
     launches; TTIs/s;
 38. the calibrated BLER tables for MCS 0, 4 and 10 against DlsimAwgn as
     tests/test_observability.py::test_calibrated_table_matches_full_phy
     holds them, the full-stack command line with 16 UEs over 2 eNBs
     (every UE registered and echoed), the 33.401 EEA2/EIA2 vectors
     through the port's AES, and whether `cryptography` is importable;
 39. the single-UE capstone at the reference test's size (25 PRB, 12 dB,
     seed 0; decoder window 240 on both sides) on the CPU and on the
     card: the result (every flag, TTIs, PHY runs, the trace), the pcap
     bytes and the MSC text equal; only v2 launches;
 40. FullStackSim at 100 PRB: the ladder (12 dB, seed 0) with every
     assertion of tests/test_capstone.py::test_full_stack_over_the_air
     and the JAX run's 53 TTIs and PHY runs, the 450 B NAS ladder and the
     mobile-terminated attach through paging with their reference tests'
     assertions; the ms of each DL, UL and PRACH PHY TTI, v2's launches by
     shape, each run's seconds;
 41. MultiUeSim at 100 PRB: 4 UEs under the PF scheduler on measured CQI
     (18 dB, a 9 dB spread, seed 1), 2 UEs (15 dB, seed 2) and then
     HandoverPhySim, gated by the reference tests' assertions, with the
     counts beside the JAX run's at 100 PRB and ms a TTI; then v2 against
     its plain version, bit for bit, at every shape phases 39-41
     launched (batch-1 rows of one code block);
 43. the native runtime at 20 MHz (run before 42): ring, ITTI queue and
     scheduler round trips; a SoftModem paced at 1 ms with 2 workers over
     a 100 PRB framegen frame ten times over, each subframe's OFDM
     demodulation and PSS correlation on the card, the PSS found in
     subframes 0 and 5 of every frame (missed deadlines and µs a subframe
     printed, not gated); an RrhLoopback round trip of a 100 PRB subframe
     with AWGN, its hard decisions exact;
 44. the parallel modules on the card, each rank a process of its own
     that loads phase 2's library (run before 42): a. world 1 on NCCL:
     entry() once, make_flagship_sharded at batch 128, 26 dB, 2
     iterations (its TB errors those of the same round in this process
     on the same draws, no DCI miss), the distributed sweep of DlsimAwgn
     (25 PRB, MCS 4, -3 to -2 dB, 128 frames) at 16 a rank, the
     time-sharded PSS correlation at n_t = 1; b. world 2 on gloo, both
     ranks on cuda:0: the flagship at 64 a rank gives a.'s counts, the
     sweep at 8 a rank gives a.'s rows and the sim's own run_snr at batch
     16, a sweep preempted after its first point and resumed from its
     checkpoint gives the unbroken one, the correlation at n_t = 2 (its
     halo through a host copy: gloo sends CPU tensors only); c. world 4
     on gloo: the correlation at n_t = 4, on 155,648-sample 20 MHz
     captures with peaks inside a block, straddling each boundary, at the
     last position searched and in noise: pos and NID2 equal
     CellSearch.pss_correlate's on the whole capture; d. every (kernel,
     shape) the ranks launched that no earlier phase held (v2 at 704 x
     5,760, mrc_llr at [64, 15,000] Qm 6 and [64, 756] Qm 2, the AWGN
     sweep's and entry()'s v2 shapes) against its plain version. Each
     rank's step and collective times are printed, not gated: ranks that
     share one card measure no scaling;
 45. the port bench (run before 42): openair4g_tpu_torch.bench's four
     cells at bench.py's sizes and window counts (the flagship round 0,
     DlsimAwgn 25 PRB MCS 4 at batch 512, the turbo decode of MCS 10 on
     50 PRB at batch 512 with dynamic_stop off and on, the 20 MHz front
     end), each between launch-count resets: its rates (best and median
     window) printed as the bench prints them; the fixed-8 decode
     launches v2 2 x 8 times a call, the dynamic stop fewer, the front end
     none; v2 at the turbo cell's 1,024 x 4,080 bit for bit, mrc_llr at
     the flagship cell's shapes within rtol = atol = 3e-4, every other
     (kernel, shape) the cells launched against its plain version;
 46. the campaign programs (openair4g_tpu_torch.scripts) through their
     command lines into a temporary --out-dir at 1,024 trials (256 for
     the fading corpus, the Doppler sweep and the EVA ablation): the
     AWGN ladder's MCS 10 at 2.9-3.1 dB, fidelity txdiv64 at 13 and 14
     dB and ulsim16 at 3 dB, the uplink ladder's awgn10 at 2.75 dB and
     prach_roc fmt0_ncs13 at threshold 14, each count within Z_BAND = 4
     pooled two-proportion sd of the committed run's (taken on a TPU);
     the turbo roofline at K = 6,144, batch 512; the flagship's stage
     split and A/B profile; the sharded flagship in 1, 2 and 4 ranks
     (their launches are the ranks', not counted here); every output
     with the committed file's keys (turbo_roofline's less its TPU
     units) and CSV header plus device and seconds; a second run of each
     program skips every configuration; then every (kernel, shape) they
     launched against its plain version;
 42. observability on the flagship (phase 5's configuration): sweep with
     profile=True prints the time_meas table, each stage counted once a
     trial; the step time with the profiler on and off, in turns; then
     trace_dir writes a trace with the dlsim.step span and
     turbo_half_iter_kernel device events (this holds a profiler
     session, so it runs after every other path);
 16. (run last) the device time of every kernel at each shape phases 3,
     6, 7, 11, 17, 23, 28, 33, 35, 41 and 44-46 timed, by torch.profiler's
     device-side events (the kernel alone, without the host's enqueue
     time that CUDA events around back-to-back calls of a few-µs kernel
     measure), each beside the launch floor, the device time of an empty <<<1, 32>>> kernel of the
     same library (kernels of different names share a profiler session);
     then the device kernels, copies and fills of one v1 call, which must
     be its one kernel; then the device time a step of phase 13's, 19's,
     24's and 29's paths, with the v2 kernel's share of the uplink, MBSFN
     and full-chain steps', of a call of each phase 26 path, and of a TTI
     of phase 36's and 37's Oaisims, with v2's share of the first, and of
     one 100 PRB capstone DL PHY TTI and one 4-UE multi-UE TTI, and of a
     step of each bench cell (a decode of each turbo mode). It runs
     last: the profiler is started after every path has run, so no path
     is timed in a process that has held a profiling session.
Each path is driven with the launch counts set to 0 just before it and
read just after; every kernel must have launched on its path (v1, which
no path runs, in its own timed run). Each phase prints its seconds. Ends
with a JSON line of the kernels (launches on the paths, launches per
flagship step, error, times, and the bound: the least time the card could
take for the same work, from its bytes or operations; the v2 kernel has a
row at the uplink shape, with the uplink paths' launches, one at the
MBSFN shape, with the MBSFN paths'; each (kernel, shape) of phases 28 and
33 has a row with the launches of that shape alone in phases 29-32, by
phase, those a step of the first run where it ran, and its share of its
bound; v2 at the full-PHY oaisim shape with phase 36's launches, those a
TTI, and phases 36's and 37's device time a TTI; v2 at each capstone
shape with its launches by phase in 39-41, the device time of a capstone
DL PHY TTI and of a multi-UE TTI, the SoftModem's missed deadlines and
the flagship step with the profiler on and off; each (kernel, shape) of
phases 44d, 45 and 46 with the launches at it there, launches_by_phase
{phase: n}, and their launches at phase 3's flagship shapes added to those
rows; v2 at the bench's turbo shape with its launches a decode of each
mode and each decode's device time),
then the device JSON line. It needs a CUDA device and imports
nothing of JAX.
"""
import contextlib
import functools
import importlib.util
import io
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from openair4g_tpu_torch import bench, kernels
from openair4g_tpu_torch.config import FrameParms
from openair4g_tpu_torch.device import (FP32_OPS_S, HBM_BYTES_S,
                                        launch_counts, launch_shapes,
                                        reset_launch_counts)
from openair4g_tpu_torch.epc import crypto
from openair4g_tpu_torch.ops.equalize_llr import (demap_llr_fused,
                                                  demap_llr_fused_ref,
                                                  mrc_llr, mrc_llr_ref)
from openair4g_tpu_torch.ops.turbo_cuda import (TURBO_OPS_PER_POS,
                                                half_iteration,
                                                half_iteration_prepped,
                                                half_iteration_prepped_ref,
                                                half_iteration_ref,
                                                prep_parity, scratch_numel)
from openair4g_tpu_torch.ops.gold import scramble_bits
from openair4g_tpu_torch.ops.llr import map_symbols
from openair4g_tpu_torch.phy.control_region import make_control_region_map
from openair4g_tpu_torch.phy.dci_formats import n_rbg, pack_dci_format1
from openair4g_tpu_torch.phy.ofdm import ofdm_demodulate, ofdm_modulate
from openair4g_tpu_torch.phy.pdcch import ue_search_candidates
from openair4g_tpu_torch.phy.pdsch import DlschCodec
from openair4g_tpu_torch.phy.resource_grid import (extract_data_res,
                                                   fill_grid, make_grid_map)
from openair4g_tpu_torch.parallel.launch import spawn
from openair4g_tpu_torch.phy.sync import CellSearch, pss_time_replica
from openair4g_tpu_torch.rrc.paging import (PagingConfig, is_paging_occasion,
                                            ue_paging_id)
from openair4g_tpu_torch.phy.srs import SrsConfig
from openair4g_tpu_torch.sched import (CellConfig, EnbRx, EnbTx, UeRx, UeTx,
                                       UeUlConfig)
from openair4g_tpu_torch.sim import capstone as capstone_mod
from openair4g_tpu_torch.sim.capstone import (SI_RNTI, CapstoneConfig,
                                              FullStackSim)
from openair4g_tpu_torch.sim.capstone_multiue import (HandoverPhySim,
                                                      MultiUeSim)
from openair4g_tpu_torch.sim.dlsim import (DlsimAwgn, DlsimConfig,
                                           DlsimFading, DlsimFadingConfig,
                                           dlsim_snr_offset_db)
from openair4g_tpu_torch.sim.framegen import generate_frame
from openair4g_tpu_torch.sim.fullsim import FullChainSim, FullsimConfig
from openair4g_tpu_torch.sim.harness import dlsim_main, fullsim_main
from openair4g_tpu_torch.scripts import (awgn_campaign, doppler_campaign,
                                         eva_ablation, fading_campaign,
                                         fidelity_campaign, flagship_profile,
                                         flagship_stages, prach_roc,
                                         scale_campaign, turbo_roofline,
                                         ulsim_campaign)
from openair4g_tpu_torch.scripts.common import two_proportion_z
from openair4g_tpu_torch.sim.dlsim_mimo import DlsimTxDiv, DlsimTxDivConfig
from openair4g_tpu_torch.sim.dlsim_sm import DlsimSm, DlsimSmConfig
from openair4g_tpu_torch.sim.oaisim import (Oaisim, OaisimConfig,
                                            calibrated_bler_table)
from openair4g_tpu_torch.sim.phase_split import OAISIM_FULL, profile_steps
from openair4g_tpu_torch.ops.uci import UciConfig
from openair4g_tpu_torch.sim.mbmssim import Mbmssim, MbmssimConfig
from openair4g_tpu_torch.sim.pbchsim import Pbchsim, PbchsimConfig
from openair4g_tpu_torch.sim.pdcchsim import Pdcchsim, PdcchsimConfig
from openair4g_tpu_torch.sim.prachsim import Prachsim, PrachsimConfig
from openair4g_tpu_torch.sim.pucchsim import Pucchsim, PucchsimConfig
from openair4g_tpu_torch.sim.pucchsim import main as pucchsim_main
from openair4g_tpu_torch.sim.scansim import CarrierScan, ScanConfig
from openair4g_tpu_torch.sim.syncsim import Syncsim, SyncsimConfig
from openair4g_tpu_torch.sim.tddsim import TddFrameSim, TddsimConfig
from openair4g_tpu_torch.sim.ulgrantsim import UlGrantConfig, UlGrantSim
from openair4g_tpu_torch.sim.ulsim import Ulsim, UlsimConfig
from openair4g_tpu_torch.utils import profiler
from openair4g_tpu_torch.utils.opt import (DIR_DL, DIR_UL, KIND_IP, KIND_MAC,
                                           read_pcap)
from openair4g_tpu_torch.utils.tracing import trace_artifacts

# Flagship shapes: 128 subframes x 11 code blocks of K = 5632 decode as
# 1,408 rows of N = 5760 (24 windows of W = 240); 15,000 data REs and
# 756 PDCCH REs per subframe.
BATCH = 128
TURBO_ROWS, TURBO_W, TURBO_U, TURBO_NW = BATCH * 11, 240, 24, 24
N_DATA, N_PDCCH_RE = 15000, 756
# The turbo kernels and their plain versions run the same float32
# operations in the same order: they must be equal bit for bit.
TURBO_ATOL = 0.0
# mrc_llr: the kernel forms -(num - l h2)^2 / (h2 n0), the plain version
# (num/h2 - l)^2 / (n0/h2): same value, other rounding (as the reference's
# tests/test_equalize_llr.py tolerates).
MRC_RTOL = MRC_ATOL = 3e-4
# The v2 scratch's limit at the flagship: one beta checkpoint per block
# takes 32.4 MB; a per-node beta stack would take 260 MB.
TURBO_SCRATCH_MAX = 40e6
# The v1 kernel's limit: the same checkpoints (a per-node stack over its
# W + U rows would take 285 MB).
TURBO_V1_SCRATCH_MAX = 45e6


def _time_ms(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def _profiled(items: list, n: int) -> list:
    """[(launches seen, summed device µs)] for each (fn, kernel name) of
    items: n back-to-back calls of each fn in turn, recorded in the second
    of two profiler cycles (the first, the same calls, lets the device
    tracing start: a session that records from its first call can miss the
    launches made while it starts). A kernel name is matched with the
    spaces taken out, and no two items of one session may share one."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(2):
            for fn, _ in items:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            prof.step()
    events = [(e.key.replace(" ", ""), e.count, e.self_device_time_total)
              for e in prof.key_averages() if e.self_device_time_total > 0]
    return [(sum(c for key, c, _ in events if kernel in key),
             sum(us for key, _, us in events if kernel in key))
            for _, kernel in items]


def _device_ms(items: list, n: int) -> list:
    """[(mean device time in ms, launches it is the mean of)] of each
    (fn, kernel name) of items, from torch.profiler's device-side events:
    the kernel alone, without the host's enqueue time that CUDA events
    around back-to-back calls of a short kernel measure. Items whose
    kernel names differ share a profiler session. The items whose device
    events miss some of their n launches are run again, up to three
    sessions in all; the mean is over every launch the best session saw,
    and no launch seen in any is an error."""
    for fn, _ in items:
        fn()
    torch.cuda.synchronize()
    best = [(0, 0.0)] * len(items)
    todo = list(range(len(items)))
    for _ in range(3):
        sessions = []            # indices, no kernel name twice in one
        for k in todo:
            for session in sessions:
                if all(items[j][1] != items[k][1] for j in session):
                    session.append(k)
                    break
            else:
                sessions.append([k])
        for session in sessions:
            seen = _profiled([items[k] for k in session], n)
            for k, got in zip(session, seen):
                best[k] = max(best[k], got)
                if got[0] != n:
                    print(f"  profiler saw {got[0]} of {n} launches of "
                          f"{items[k][1]}", flush=True)
        todo = [k for k in todo if best[k][0] != n]
        if not todo:
            break
    for k, (count, _) in enumerate(best):
        if count == 0:
            raise AssertionError("the profiler saw no launch of "
                                 f"{items[k][1]}")
    return [(us / count / 1e3, count) for count, us in best]


def _device_events(fn) -> list:
    """(name, count) of every device-side event (kernels, copies, fills)
    that one call of fn makes, by torch.profiler."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


PROFILED_STEPS = 2


def _step_device_time(fn) -> tuple:
    """(device ms a call, the v2 kernel's device ms a call, its launches
    seen, host ms a profiled call) over PROFILED_STEPS calls of fn, by
    torch.profiler."""
    events, dev_us, wall = profile_steps(fn, PROFILED_STEPS)
    v2 = [e for e in events if e.self_device_time_total > 0
          and "turbo_half_iter_kernel<" in e.key.replace(" ", "")]
    return (dev_us / PROFILED_STEPS / 1e3,
            sum(e.self_device_time_total for e in v2) / PROFILED_STEPS / 1e3,
            sum(e.count for e in v2), wall * 1e3)


def device_times(timings: list, one_launch: tuple, dd: tuple,
                 ul: tuple, mbms: tuple, steps: list, full: tuple,
                 frames: list, top_events_of=()) -> tuple:
    """Phase 16: the launch floor (an empty <<<1, 32>>> kernel of the
    library) and each (label, fn, kernel name, row) that the kernel checks
    queued, timed by _device_ms (the row, if any, takes it as device_ms);
    the device events of one call of one_launch = (label, fn, kernel name),
    which must be that kernel once and nothing else; the device time a step
    of dd = (sim, SNR), of the full-width uplink ul = (sim, SNR), of the
    full-width Mbmssim mbms = ((sim, SNR) with the channel known, (sim,
    SNR) with the MBSFN RS estimate) and of FullChainSim at the flagship
    load full = (sim, SNR), with the v2 kernel's share of each but dd's;
    then the device time a call of each (label, fn) of steps, with the v2
    kernel's part (and, for the labels in top_events_of, the five largest
    device events of a call); then the device time a TTI of each (label, Oaisim) of
    frames, a call being one frame of 10 TTIs, with the v2 kernel's share.
    Returns the uplink's, the first Mbmssim's and the FullChainSim's
    figures, those of frames by label and those of steps by label."""
    lib = kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    items = [(lambda: kernels.check(lib.empty_launch(stream), "empty"),
              "empty_kernel")] + [(fn, kernel) for _, fn, kernel, _ in timings]
    (floor, count), *times = _device_ms(items, 20)
    print(f"launch floor: an empty <<<1, 32>>> kernel takes {floor:.4f} ms "
          f"of device time (mean of {count} launches)", flush=True)
    for (label, _, _, row), (ms, count) in zip(timings, times):
        print(f"{label}: device time {ms:.4f} ms (mean of {count} "
              f"launches; launch floor {floor:.4f} ms)", flush=True)
        if row is not None:
            row["device_ms"] = ms
            row["launch_floor_ms"] = floor

    label, fn, kernel = one_launch
    fn()
    for _ in range(3):       # a session can miss events: none seen, again
        seen = _device_events(fn)
        if seen:
            break
    print(f"{label}: the device events of one call: {seen}", flush=True)
    if len(seen) != 1 or kernel not in seen[0][0] or seen[0][1] != 1:
        raise AssertionError(f"{label}: one call must be one launch of "
                             f"{kernel} and no other device work: {seen}")

    sim, snr = dd
    snr += dlsim_snr_offset_db(sim.gm)
    n0 = 10.0 ** (-snr / 10.0)
    gen = torch.Generator(device=sim.device).manual_seed(5)
    W, ev = sim.wiener(snr), sim.err_var(snr)
    dev_ms, _, _, wall = _step_device_time(lambda: sim.step(gen, n0, W, ev))
    print(f"dd 1x2 100 PRB, 4 rounds: {dev_ms:.2f} ms device time a step "
          f"over {PROFILED_STEPS} profiled steps ({wall:.1f} ms a profiled "
          "step on the host)", flush=True)

    def state(sim, snr):
        """The step's estimator state after (generator, n0)."""
        if sim is ul[0]:
            return (sim.wiener(snr),)
        if sim is full[0]:
            return (sim.ue.make_wiener(10.0 ** (-snr / 10.0)),)
        return ()

    figures = []
    for (sim, snr), label in [(ul, "uplink 100 PRB MCS 20 EVA 4 rounds")] + [
            (m, f"Mbmssim 100 PRB MCS 22, {what},")
            for m, what in zip(mbms, ("channel known", "MBSFN RS estimate"))
    ] + [(full, "fullsim 100 PRB MCS 26 EVA 4 rounds")]:
        gen = torch.Generator(device=sim.device).manual_seed(5)
        n0 = 10.0 ** (-snr / 10.0)
        args = state(sim, snr)
        dev_ms, v2_ms, v2_n, wall = _step_device_time(
            lambda: sim.step(gen, n0, *args))
        share = v2_ms / dev_ms if dev_ms else 0.0
        print(f"{label} at {snr} dB: {dev_ms:.2f} ms device time a step over "
              f"{PROFILED_STEPS} profiled steps, the v2 kernel {v2_ms:.2f} ms "
              f"of it ({share:.1%}, {v2_n} launches seen); {wall:.1f} ms a "
              "profiled step on the host", flush=True)
        figures.append({"step_device_ms": dev_ms,
                        "kernel_device_ms_per_step": v2_ms,
                        "kernel_share": share, "profiled_step_ms": wall})
    by_step = {}
    for label, fn in steps:
        dev_ms, v2_ms, v2_n, wall = _step_device_time(fn)
        print(f"{label}: {dev_ms:.2f} ms device time a call over "
              f"{PROFILED_STEPS} profiled calls, the v2 kernel {v2_ms:.3f} ms"
              f" of it ({v2_n} launches seen); {wall:.1f} ms a profiled call"
              " on the host", flush=True)
        by_step[label] = {"device_ms": dev_ms, "kernel_device_ms": v2_ms,
                          "profiled_ms": wall}
        if label in top_events_of:
            events, _, _ = profile_steps(fn, PROFILED_STEPS)
            top = sorted((e for e in events if e.self_device_time_total > 0
                          and e.device_type ==
                          torch.autograd.DeviceType.CUDA),
                         key=lambda e: -e.self_device_time_total)[:5]
            print("  its largest device events a call: " + "; ".join(
                f"{e.key[:60]} {e.self_device_time_total / PROFILED_STEPS / 1e3:.3f}"
                f" ms x{e.count // PROFILED_STEPS}" for e in top), flush=True)
    per_tti = {}
    for label, sim in frames:
        dev_ms, v2_ms, v2_n, wall = _step_device_time(
            lambda: sim.run_frames(1))
        share = v2_ms / dev_ms if dev_ms else 0.0
        print(f"{label}: {dev_ms / 10:.3f} ms device time a TTI over "
              f"{PROFILED_STEPS} profiled frames, the v2 kernel "
              f"{v2_ms / 10:.3f} ms of it ({share:.1%}, {v2_n} launches "
              f"seen); {wall / 10:.1f} ms a profiled TTI on the host",
              flush=True)
        per_tti[label] = {"tti_device_ms": dev_ms / 10,
                          "kernel_device_ms_per_tti": v2_ms / 10,
                          "kernel_share": share, "profiled_tti_ms": wall / 10}
    return figures[0], figures[1], figures[3], per_tti, by_step


def _bound(n_bytes: float, n_ops: float) -> dict:
    """The least time for moving n_bytes and doing n_ops float32
    operations on the card, and which of the two sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / FP32_OPS_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_turbo(dev, gen, timings) -> dict:
    N = TURBO_W * TURBO_NW
    lin = 3.0 * torch.randn(TURBO_ROWS, N, generator=gen, device=dev)
    lp = 3.0 * torch.randn(TURBO_ROWS, N, generator=gen, device=dev)
    lin[:, -TURBO_W // 2:] = 1e4       # the forced pad region after the tail
    lp[:, -TURBO_W // 2:] = 1e4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    got = half_iteration(lin, lp, TURBO_W, TURBO_U)
    torch.cuda.synchronize()
    call_peak = torch.cuda.max_memory_allocated() - held
    want = half_iteration_ref(lin, lp, TURBO_W, TURBO_U)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    lanes = TURBO_ROWS * TURBO_NW
    # measured: what the call allocated beyond its output
    scratch = call_peak - 4 * got.numel()
    print(f"turbo_half_iter [{TURBO_ROWS}, {N}] W={TURBO_W} U={TURBO_U} "
          f"lanes={lanes}: max|diff| {err:.3g} (tol {TURBO_ATOL}); "
          f"the call's peak {call_peak} bytes above the {held} held before "
          f"it, {scratch} of them scratch (the checkpoints' size "
          f"{4 * scratch_numel(lanes, TURBO_W, TURBO_U)})", flush=True)
    if not err <= TURBO_ATOL:
        raise AssertionError(f"turbo kernel disagrees: {err}")
    if scratch > TURBO_SCRATCH_MAX:
        raise AssertionError(f"turbo kernel scratch {scratch} bytes")
    kernel = functools.partial(half_iteration, lin, lp, TURBO_W, TURBO_U)
    ms = _time_ms(kernel, 20)
    plain = _time_ms(lambda: half_iteration_ref(lin, lp, TURBO_W, TURBO_U), 3)
    bound = _bound(3 * 4 * TURBO_ROWS * N, TURBO_OPS_PER_POS * TURBO_ROWS * N)
    print(f"  kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}); share of the "
          f"bound (bound / time) {bound['bound_ms'] / ms:.1%}", flush=True)
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
           "scratch_bytes": scratch, **bound}
    timings.append(("turbo_half_iter flagship", kernel,
                    "turbo_half_iter_kernel<", row))
    return row


def _mrc_bound(n_re: int, A: int, Qm: int, n0_numel: int) -> dict:
    """y and H complex64 [n, A] in, n0 float32, LLRs float32 [n, Qm] out;
    about 12 operations an antenna (MRC sums) and 10 a bit (max-log
    metrics) per RE."""
    return _bound(16 * n_re * A + 4 * n0_numel + 4 * n_re * Qm,
                  (12 * A + 10 * Qm) * n_re)


def check_mrc(dev, gen, timings) -> dict:
    cases = [("PDSCH", 1, 6, (BATCH, N_DATA), "per-RE"),
             ("PDCCH", 1, 2, (BATCH, N_PDCCH_RE), "scalar"),
             ("2RX", 2, 4, (BATCH, N_DATA), "per-RE")]
    out = {}
    worst = 0.0
    for name, A, Qm, lead, kind in cases:
        def cplx():
            return torch.view_as_complex(
                torch.randn(*lead, A, 2, generator=gen, device=dev))
        y, H = cplx(), cplx()
        n0 = 0.37 if kind == "scalar" else \
            0.01 + torch.rand(lead[-1], generator=gen, device=dev)
        got = mrc_llr(y, H, n0, Qm)
        want = mrc_llr_ref(y, H, n0, Qm)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err = diff.max().item()
        ratio = (diff / (MRC_ATOL + MRC_RTOL * want.abs())).max().item()
        ms = _time_ms(lambda: mrc_llr(y, H, n0, Qm), 50)
        plain = _time_ms(lambda: mrc_llr_ref(y, H, n0, Qm), 5)
        n_re = lead[0] * lead[1]
        bound = _mrc_bound(n_re, A, Qm, 1 if kind == "scalar" else lead[1])
        print(f"mrc_llr {name} A={A} Qm={Qm} REs={n_re} "
              f"n0 {kind}: max|diff| {err:.3g}, max |diff|/(atol+rtol|ref|)"
              f" {ratio:.3g} (must be <= 1); kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']})", flush=True)
        if not ratio <= 1.0:
            raise AssertionError(f"mrc_llr {name} disagrees: {ratio}")
        worst = max(worst, err)
        row = None
        if name == "PDSCH":
            out = row = {"ms": ms, "plain_ms": plain, **bound}
        timings.append((f"mrc_llr {name} A={A} Qm={Qm} REs={n_re}",
                        functools.partial(mrc_llr, y, H, n0, Qm),
                        f"mrc_llr_kernel<{A},{Qm}>", row))
    out["max_abs_err"] = worst
    return out


def check_small_input(dev) -> None:
    """25 PRB MCS 26 round 0: the card's path (kernels) against the CPU's
    (plain versions) on the same injected draws."""
    cfg = DlsimFadingConfig(mcs=26, n_rb=25, channel="EVA", n_rx=1,
                            n_harq_rounds=1, batch=4, est_mode="joint",
                            n_turbo_iter=4, est_prior="exp")
    snr = 30.0
    n0 = 10.0 ** (-snr / 10.0)
    gen = torch.Generator().manual_seed(7)
    sims = {d: DlsimFading(cfg, device=d) for d in ("cpu", dev)}
    tb = torch.randint(0, 2, (4, sims["cpu"].dlsch.cfg.tbs), generator=gen,
                       dtype=torch.int32)
    taps = torch.randn(4, 1, 1, sims["cpu"].chan.n_taps, 2, generator=gen)
    noise = torch.randn(4, 1, sims["cpu"].fp.samples_per_tti, 2,
                        generator=gen)
    res = {d: s.trial(tb, [taps], [noise], n0, s.wiener(snr),
                      s.err_var(snr)).rounds[0] for d, s in sims.items()}
    cpu, gpu = res["cpu"], res[dev]
    for field in ("ok", "dci_ok", "bit_errs"):
        a, b = getattr(cpu, field), getattr(gpu, field).cpu()
        if not torch.equal(a, b):
            raise AssertionError(f"small input: {field} {a} (CPU) vs {b}")
    if not bool(cpu.ok.all()):
        raise AssertionError(f"small input: not every TB decoded {cpu.ok}")
    worst = 0.0
    for a, b in zip(cpu.w_soft, gpu.w_soft):
        b = b.cpu()
        worst = max(worst, ((a - b).abs() / (1e-3 + 1e-3 * a.abs())).max()
                    .item())
    print(f"small input 25 PRB MCS 26 B=4 at {snr} dB: ok/dci_ok/bit_errs "
          f"equal on card and CPU; soft buffers max |diff|/(1e-3+1e-3|cpu|)"
          f" {worst:.3g} (must be <= 1)", flush=True)
    if not worst <= 1.0:
        raise AssertionError(f"small input soft buffers disagree: {worst}")


def flagship(dev) -> tuple:
    cfg = DlsimFadingConfig(mcs=26, n_rb=100, channel="EVA", n_rx=1,
                            n_harq_rounds=1, batch=BATCH, est_mode="joint",
                            n_turbo_iter=8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    reset_launch_counts()

    sim = DlsimFading(cfg, device=dev)
    n0 = 10.0 ** (-26.0 / 10.0)
    r = sim.step(gen, n0, sim.wiener(26.0), sim.err_var(26.0)).rounds[0]
    torch.cuda.synchronize()
    n_ok, n_dci = int(r.ok.sum()), int(r.dci_ok.sum())
    print(f"flagship 26 dB: {n_ok}/{BATCH} TBs, {n_dci}/{BATCH} DCIs, "
          f"{int(r.bit_errs.sum())} bit errors", flush=True)
    if n_ok != BATCH or n_dci != BATCH or int(r.bit_errs.sum()) != 0:
        raise AssertionError("flagship at 26 dB must decode every TB and DCI")

    sim = DlsimFading(cfg, device=dev)            # bench SNR, fresh prior
    n0 = 10.0 ** (-24.0 / 10.0)
    W, ev = sim.wiener(24.0), sim.err_var(24.0)
    sim.step(gen, n0, W, ev)                      # settle the allocator
    torch.cuda.synchronize()
    n_rep = 10
    errs = trials = 0
    t0 = time.perf_counter()
    oks = [sim.step(gen, n0, W, ev).rounds[0].ok for _ in range(n_rep)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for ok in oks:
        errs += int((~ok).sum())
        trials += ok.numel()
    sf_per_s = n_rep * BATCH / dt
    counts = launch_counts()
    print(f"flagship 24 dB: BLER {errs / trials:.4f} ({errs}/{trials}), "
          f"{sf_per_s:.1f} subframes/s ({n_rep} steps of {BATCH}, "
          f"{dt:.3f} s)", flush=True)
    print(f"launches over the flagship runs: {counts}", flush=True)
    if errs == trials:
        raise AssertionError("flagship at 24 dB decodes no TB")
    if min(counts["turbo_half_iter"], counts["mrc_llr"]) == 0:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    return counts, 2 + n_rep       # steps: 26 dB, settle, timed


def _worst_ratio(got, want, rtol, atol) -> tuple:
    diff = (got - want).abs()
    return diff.max().item(), (diff / (atol + rtol * want.abs())).max().item()


def check_demap(dev, gen, timings) -> dict:
    """demap_llr at the multi-antenna paths' shapes: one layer of TM3's
    MMSE output [64, 14,400, 2] at 100 PRB (read in place at stride 2),
    TM2's SFBC output at 50 PRB batch 128, the SFBC PDCCH."""
    n_pdcch = make_control_region_map(50, 1).n_cce * 36
    cases = [("TM3 layer 0", 6, (64, 14400), 0),
             ("TM3 layer 1", 4, (64, 14400), 1),
             ("TM2", 6, (128, 7200), None),
             ("SFBC PDCCH", 2, (128, n_pdcch), None)]
    out = {}
    worst = 0.0
    for name, Qm, lead, layer in cases:
        shape = lead + ((2,) if layer is not None else ())
        x = torch.view_as_complex(torch.randn(*shape, 2, generator=gen,
                                              device=dev)) * 0.7
        n0 = 0.01 + torch.rand(*shape, generator=gen, device=dev)
        if layer is not None:
            x, n0 = x[..., layer], n0[..., layer]
        got = demap_llr_fused(x, n0, Qm)
        want = demap_llr_fused_ref(x, n0, Qm)
        torch.cuda.synchronize()
        err, ratio = _worst_ratio(got, want, MRC_RTOL, MRC_ATOL)
        ms = _time_ms(lambda: demap_llr_fused(x, n0, Qm), 50)
        plain = _time_ms(lambda: demap_llr_fused_ref(x, n0, Qm), 5)
        n_re = lead[0] * lead[1]
        # x complex64 and n0 float32 in, Qm LLRs out; about 10 operations
        # a bit
        bound = _bound((8 + 4 + 4 * Qm) * n_re, 10 * Qm * n_re)
        print(f"demap_llr {name} Qm={Qm} REs={n_re} "
              f"{'stride 2' if layer is not None else 'contiguous'}: "
              f"max|diff| {err:.3g}, max |diff|/(atol+rtol|ref|) {ratio:.3g}"
              f" (must be <= 1); kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})",
              flush=True)
        if not ratio <= 1.0:
            raise AssertionError(f"demap_llr {name} disagrees: {ratio}")
        worst = max(worst, err)
        row = None
        if name == "TM3 layer 0":
            out = row = {"ms": ms, "plain_ms": plain, **bound}
        timings.append((f"demap_llr {name} Qm={Qm} REs={n_re}",
                        functools.partial(demap_llr_fused, x, n0, Qm),
                        f"demap_llr_kernel<{Qm}>", row))
    out["max_abs_err"] = worst
    return out


def check_turbo_v1(dev, gen, timings) -> tuple:
    """The v1 kernel at the flagship shapes against its plain version and
    the v2 kernel, with the scratch one call allocates. No path of the
    system runs v1, so its launch count is that of its own timed run
    (counts reset just before it), one launch a call."""
    N = TURBO_W * TURBO_NW
    lin = 3.0 * torch.randn(TURBO_ROWS, N, generator=gen, device=dev)
    lp = 3.0 * torch.randn(TURBO_ROWS, N, generator=gen, device=dev)
    lin[:, -TURBO_W // 2:] = 1e4
    lp[:, -TURBO_W // 2:] = 1e4
    gpf, gpb = prep_parity(lp, TURBO_W, TURBO_U)
    half_iteration_prepped(lin, gpf, gpb, TURBO_W, TURBO_U)   # built, loaded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    got = half_iteration_prepped(lin, gpf, gpb, TURBO_W, TURBO_U)
    torch.cuda.synchronize()
    # measured: what the call allocated beyond its output
    scratch = torch.cuda.max_memory_allocated() - held - 4 * got.numel()
    want = half_iteration_prepped_ref(lin, gpf, gpb, TURBO_W, TURBO_U)
    v2 = half_iteration(lin, lp, TURBO_W, TURBO_U)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    interior = torch.ones(N, dtype=torch.bool, device=dev)
    interior[TURBO_W - 1::TURBO_W] = False
    d_v2 = (got - v2)[:, interior].abs().max().item()
    reset_launch_counts()
    ms = _time_ms(lambda: half_iteration_prepped(lin, gpf, gpb, TURBO_W,
                                                 TURBO_U), 20)
    n_v1 = launch_counts()["turbo_half_iter_v1"]
    if n_v1 != 21:           # _time_ms: one warm-up call and the 20 timed
        raise AssertionError(f"21 v1 calls made {n_v1} launches")
    plain = _time_ms(lambda: half_iteration_prepped_ref(lin, gpf, gpb,
                                                        TURBO_W, TURBO_U), 3)
    # lin [B, N] and the two parity frames [W+U, L] in, [B, N] out
    n_pos = TURBO_ROWS * N
    bound = _bound(4 * (2 * n_pos + gpf.numel() + gpb.numel()),
                   TURBO_OPS_PER_POS * n_pos)
    # the bytes the function needs: rows U.. of gpf repeat rows 0..W-1 of
    # gpb, so of gpf only the U warm-up rows
    needed = _bound(4 * (2 * n_pos + TURBO_U * gpf.shape[1] + gpb.numel()),
                    TURBO_OPS_PER_POS * n_pos)
    print(f"turbo_half_iter_v1 [{TURBO_ROWS}, {N}] W={TURBO_W} U={TURBO_U}: "
          f"max|diff| {err:.3g} (tol {TURBO_ATOL}); max|diff| to the v2 "
          f"kernel on interior nodes {d_v2:.3g} (bound 0.05); kernel "
          f"{ms:.4f} ms over {n_v1} launches in {n_v1} calls, plain "
          f"{plain:.4f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}, every input once; with gpf's {TURBO_U} "
          f"warm-up rows only, the rest being in gpb, "
          f"{needed['bound_ms']:.4f} ms by {needed['bound_by']}); the "
          f"call's scratch {scratch} bytes (the "
          f"checkpoints' size "
          f"{4 * scratch_numel(TURBO_ROWS * TURBO_NW, TURBO_W, TURBO_U)}; "
          f"limit {TURBO_V1_SCRATCH_MAX:.0f})", flush=True)
    if not err <= TURBO_ATOL:
        raise AssertionError(f"turbo v1 kernel disagrees: {err}")
    if not d_v2 <= 0.05:
        raise AssertionError(f"turbo v1 and v2 disagree inside windows: {d_v2}")
    if scratch > TURBO_V1_SCRATCH_MAX:
        raise AssertionError(f"turbo v1 kernel scratch {scratch} bytes")
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
           "scratch_bytes": scratch, **bound,
           "needed_bound_ms": needed["bound_ms"],
           "needed_bound_by": needed["bound_by"]}
    call = functools.partial(half_iteration_prepped, lin, gpf, gpb, TURBO_W,
                             TURBO_U)
    timings.append(("turbo_half_iter_v1 flagship", call,
                    "turbo_half_iter_v1_kernel<", row))
    return row, n_v1, ("turbo_half_iter_v1 flagship", call,
                       "turbo_half_iter_v1_kernel")


_SMALL_MIMO = [("TM2", dict(mcs=25, channel="EVA")),
               ("TM3", dict(tm=3, mcs=16, mcs2=9)),
               ("TM4", dict(tm=4, mcs=11, mcs2=11, pmi=2)),
               ("TM5 IA", dict(tm=5, mcs=12, pmi=0, pmi_interferer=1)),
               ("TM6", dict(tm=6, mcs=20, pmi=3))]


def check_small_mimo(dev) -> None:
    """25 PRB, batch 4, 30 dB, decoder window 240 on both sides: the card's
    path (kernels) against the CPU's (plain versions) on the same draws."""
    B, snr = 4, 30.0
    n0 = 10.0 ** (-snr / 10.0)
    for name, case in _SMALL_MIMO:
        common = dict(n_rb=25, batch=B, n_turbo_iter=4, decoder_window=240,
                      **case)
        gen = torch.Generator().manual_seed(11)
        if name == "TM2":
            sims = {d: DlsimTxDiv(DlsimTxDivConfig(**common), device=d)
                    for d in ("cpu", dev)}
            s = sims["cpu"]
            draws = (torch.randint(0, 2, (B, s.dlsch.cfg.tbs), generator=gen,
                                   dtype=torch.int32),
                     torch.randn(B, 2, 2, s.chan.n_taps, 2, generator=gen),
                     torch.randn(B, 2, s.fp.samples_per_tti, 2,
                                 generator=gen))
            extra = ()
        else:
            sims = {d: DlsimSm(DlsimSmConfig(**common), device=d)
                    for d in ("cpu", dev)}
            s = sims["cpu"]
            draws = ([torch.randint(0, 2, (B, c.cfg.tbs), generator=gen,
                                    dtype=torch.int32) for c in s.codecs],
                     torch.randn(B, 2, 2, 2, generator=gen),
                     torch.randn(B, 2, s.fp.samples_per_tti, 2,
                                 generator=gen))
            extra = (torch.randint(0, 4, (B, s.gm.n_data_re),
                                   generator=gen),) if case["tm"] == 5 else ()
        res = {d: sim.trial(*draws, n0, *sim.wiener(snr), *extra)
               for d, sim in sims.items()}
        cpu, gpu = res["cpu"], res[dev]
        for field in ("ok", "dci_ok", "bit_errs"):
            a, b = getattr(cpu, field), getattr(gpu, field).cpu()
            if not torch.equal(a, b):
                raise AssertionError(f"small {name}: {field} {a} (CPU) vs {b}")
        if not bool(cpu.dci_ok.all()):
            raise AssertionError(f"small {name}: a DCI was missed at {snr} dB")
        worst = max(_worst_ratio(g.cpu(), c, 1e-3, 1e-3)[1]
                    for c, g in zip(cpu.llr, gpu.llr))
        print(f"small {name} 25 PRB B={B} at {snr} dB: ok {cpu.ok.tolist()}, "
              f"dci_ok and bit_errs equal on card and CPU; decoder-input "
              f"LLRs max |diff|/(1e-3+1e-3|cpu|) {worst:.3g}", flush=True)


def tm2_anchor(dev) -> int:
    """TM2 SFBC 50 PRB MCS 25 EVA 2x2, estimated channel, batch 128: 2048
    trials at 14 and 15 dB against fidelity_campaign.json "txdiv64"
    (0.0703 and 0.0107 over 2048 trials each, taken on a TPU); the bands
    are about 3.3 sigma of a two-sample binomial difference."""
    sim = DlsimTxDiv(DlsimTxDivConfig(mcs=25, n_rb=50, n_rx=2, channel="EVA",
                                      batch=128), device=dev)
    W0, W1 = sim.wiener(14.0)
    sim.step(torch.Generator(device=dev).manual_seed(99), 10 ** -1.4, W0, W1)
    torch.cuda.synchronize()
    reset_launch_counts()
    bler = {}
    for snr in (14.0, 15.0):
        t0 = time.perf_counter()
        errs, trials = sim.run_snr(snr, 2048, seed=int(snr))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        bler[snr] = errs / trials
        print(f"TM2 50 PRB MCS 25 EVA 2x2 {snr} dB: BLER {bler[snr]:.4f} "
              f"({errs}/{trials}), DCI misses {sim.dci_miss}, "
              f"{trials / dt:.1f} subframes/s ({trials // 128} steps of 128,"
              f" {dt:.3f} s)", flush=True)
    counts = launch_counts()
    print(f"launches over the TM2 runs: {counts}", flush=True)
    if not 0.044 <= bler[14.0] <= 0.097:
        raise AssertionError(f"TM2 BLER at 14 dB {bler[14.0]} outside "
                             "[0.044, 0.097]")
    if not bler[15.0] <= 0.021:
        raise AssertionError(f"TM2 BLER at 15 dB {bler[15.0]} above 0.021")
    if sim.dci_miss:
        raise AssertionError(f"TM2: {sim.dci_miss} DCI misses at 15 dB")
    if min(counts["demap_llr"], counts["turbo_half_iter"]) == 0:
        raise AssertionError(f"a kernel of the TM2 path never launched: "
                             f"{counts}")
    return counts["demap_llr"]


def tm3_full_width(dev) -> int:
    """TM3 CDD 100 PRB MCS 26/26 2x2 flat Rayleigh, estimated channel,
    batch 64, 8 turbo iterations, 10 steps at 40 dB."""
    B, n_rep = 64, 10
    sim = DlsimSm(DlsimSmConfig(tm=3, mcs=26, mcs2=26, n_rb=100, n_rx=2,
                                batch=B), device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    n0 = 10.0 ** (-40.0 / 10.0)
    W0, W1 = sim.wiener(40.0)
    sim.step(gen, n0, W0, W1)                     # settle the allocator
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = [sim.step(gen, n0, W0, W1) for _ in range(n_rep)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    errs = sum((~r.ok).sum(dim=1) for r in res).tolist()
    dci_miss = sum(int((~r.dci_ok).sum()) for r in res)
    bler = [e / (n_rep * B) for e in errs]
    print(f"TM3 100 PRB MCS 26/26 2x2 40 dB: BLER cw0 {bler[0]:.4f} "
          f"({errs[0]}/{n_rep * B}), cw1 {bler[1]:.4f} ({errs[1]}/"
          f"{n_rep * B}), DCI misses {dci_miss}, {n_rep * B / dt:.1f} "
          f"subframes/s ({n_rep} steps of {B}, {dt:.3f} s)", flush=True)
    print(f"launches over the TM3 runs: {counts}", flush=True)
    if dci_miss:
        raise AssertionError(f"TM3: {dci_miss} DCI misses at 40 dB")
    if max(bler) > 0.2:
        raise AssertionError(f"TM3 codeword BLER {bler} above 0.2")
    if min(counts["demap_llr"], counts["turbo_half_iter"]) == 0:
        raise AssertionError(f"a kernel of the TM3 path never launched: "
                             f"{counts}")
    return counts["demap_llr"]


def check_mrc_a2(dev, gen, timings) -> dict:
    """mrc_llr at A = 2 on the 1x2 path's full-width shapes: 100 PRB at
    CFI 2 (13,800 data REs, 1,980 PDCCH REs), batch 128; data Qm = 6 with
    per-RE n0, PDCCH Qm = 2 with n0 a number; interleaved [B, N, 2], and
    [B, 2, N] planes given as transposed views, which must give the same
    LLRs."""
    n_data = make_grid_map(100, 2).n_data_re
    n_pdcch = make_control_region_map(100, 2).n_cce * 36
    out, worst = {}, 0.0
    for name, Qm, n_re, per_re in (("1x2 PDSCH", 6, n_data, True),
                                   ("1x2 PDCCH", 2, n_pdcch, False)):
        y, H = (torch.view_as_complex(torch.randn(BATCH, n_re, 2, 2,
                                                  generator=gen, device=dev))
                for _ in range(2))
        n0 = 0.01 + torch.rand(n_re, generator=gen, device=dev) if per_re \
            else 0.05
        got = mrc_llr(y, H, n0, Qm)
        want = mrc_llr_ref(y, H, n0, Qm)
        # what the 1x2 receiver passes: [B, 2, N] planes as transposed views
        yp, Hp = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (y, H))
        planes = mrc_llr(yp, Hp, n0, Qm)
        torch.cuda.synchronize()
        err, ratio = _worst_ratio(got, want, MRC_RTOL, MRC_ATOL)
        ms = _time_ms(lambda: mrc_llr(y, H, n0, Qm), 50)
        planes_ms = _time_ms(lambda: mrc_llr(yp, Hp, n0, Qm), 50)
        plain = _time_ms(lambda: mrc_llr_ref(y, H, n0, Qm), 5)
        bound = _mrc_bound(BATCH * n_re, 2, Qm, n_re if per_re else 1)
        print(f"mrc_llr {name} A=2 Qm={Qm} REs={BATCH * n_re}: max|diff| "
              f"{err:.3g}, max |diff|/(atol+rtol|ref|) {ratio:.3g} (must be "
              f"<= 1); kernel {ms:.4f} ms interleaved, {planes_ms:.4f} ms on "
              f"[B, 2, N] planes (equal: {torch.equal(planes, got)}), plain "
              f"{plain:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']})", flush=True)
        timings.append((f"mrc_llr {name} A=2 Qm={Qm} REs={BATCH * n_re}",
                        functools.partial(mrc_llr, y, H, n0, Qm),
                        f"mrc_llr_kernel<2,{Qm}>", None))
        timings.append((f"mrc_llr {name} A=2 Qm={Qm} REs={BATCH * n_re} on "
                        "[B, 2, N] planes",
                        functools.partial(mrc_llr, yp, Hp, n0, Qm),
                        f"mrc_llr_kernel<2,{Qm}>", None))
        if yp.is_contiguous() or not torch.equal(planes, got):
            raise AssertionError(f"mrc_llr {name} on [B, 2, N] planes is not "
                                 "the interleaved call's result")
        if not ratio <= 1.0:
            raise AssertionError(f"mrc_llr {name} A=2 disagrees: {ratio}")
        worst = max(worst, err)
        if name == "1x2 PDSCH":
            out = {"a2_ms": ms, "a2_plain_ms": plain}
    out["a2_max_abs_err"] = worst
    return out


def _on(x, dev):
    """The estimator state (a tensor or a pair) on `dev`."""
    return tuple(t.to(dev) for t in x) if isinstance(x, tuple) else x.to(dev)


_SMALL_SISO = [("dd 1x2, 4 rounds", dict(mcs=16, channel="EVA", n_rx=2,
                                         est_mode="dd", n_harq_rounds=4)),
               ("interp AWGN", dict(mcs=16, channel="AWGN",
                                    n_harq_rounds=1)),
               ("time-domain ETU", dict(mcs=10, channel="ETU",
                                        time_domain_channel=True,
                                        n_harq_rounds=1)),
               ("EVA 200 Hz interp", dict(mcs=10, channel="EVA",
                                          intra_doppler_hz=200.0,
                                          n_harq_rounds=1)),
               ("harq_doppler 10 Hz, 2 rounds",
                dict(mcs=10, channel="EVA", harq_doppler_hz=10.0,
                     est_mode="joint", n_harq_rounds=2)),
               ("perfect CE 1x2", dict(mcs=16, channel="EVA", n_rx=2,
                                       perfect_ce=True, n_harq_rounds=1))]


def _equal_on_card_and_cpu(name, cpu, gpu) -> None:
    for field in ("ok", "dci_ok", "bit_errs"):
        a, b = getattr(cpu, field), getattr(gpu, field).cpu()
        if not torch.equal(a, b):
            raise AssertionError(f"small {name}: {field} {a} (CPU) vs {b}")


def check_small_siso(dev) -> None:
    """25 PRB, batch 4, 30 dB, decoder window 240 on both sides: each
    DlsimFading mode of this slice and DlsimAwgn, card (kernels) against
    CPU (plain versions) on the same draws and estimator state, every
    round's TB flags, DCI flags and bit errors."""
    B, snr = 4, 30.0
    n0 = 10.0 ** (-snr / 10.0)
    for name, case in _SMALL_SISO:
        cfg = DlsimFadingConfig(n_rb=25, batch=B, n_turbo_iter=4,
                                decoder_window=240, **case)
        cpu, gpu = DlsimFading(cfg, device="cpu"), DlsimFading(cfg, device=dev)
        draws = cpu.draw(torch.Generator().manual_seed(17))
        W, ev = cpu.wiener(snr), cpu.err_var(snr)
        a = cpu.trial(*draws, n0, W, ev)
        b = gpu.trial(*draws, n0, _on(W, dev), ev.to(dev))
        for r, (ra, rb) in enumerate(zip(a.rounds, b.rounds)):
            _equal_on_card_and_cpu(f"{name} round {r}", ra, rb)
        if not (torch.equal(a.errs, b.errs.cpu())
                and torch.equal(a.reach, b.reach.cpu())):
            raise AssertionError(f"small {name}: errs/reach {a.errs} "
                                 f"{a.reach} (CPU) vs {b.errs} {b.reach}")
        if not bool(a.rounds[0].dci_ok.all()):
            raise AssertionError(f"small {name}: a DCI was missed at {snr} dB")
        print(f"small {name} 25 PRB B={B} at {snr} dB: round flags "
              f"{[r.ok.tolist() for r in a.rounds]}, DCI flags and bit errors"
              f" equal on card and CPU in every round", flush=True)
    cfg = DlsimConfig(mcs=16, n_rb=25, batch=B, decoder_window=240)
    cpu, gpu = DlsimAwgn(cfg, device="cpu"), DlsimAwgn(cfg, device=dev)
    gen = torch.Generator().manual_seed(18)
    tb = torch.randint(0, 2, (B, cpu.dlsch.cfg.tbs), generator=gen,
                       dtype=torch.int32)
    noise = torch.randn(B, cpu.fp.samples_per_tti, 2, generator=gen)
    n0 = 10.0 ** (-11.0 / 10.0)
    a, b = cpu.trial(tb, noise, n0), gpu.trial(tb, noise, n0)
    _equal_on_card_and_cpu("DlsimAwgn", a, b)
    print(f"small DlsimAwgn 25 PRB MCS 16 B={B} at 11 dB: ok {a.ok.tolist()},"
          f" bit errors {a.bit_errs.tolist()} equal on card and CPU",
          flush=True)


def dd_full_width(dev) -> dict:
    """The corpus receiver at 20 MHz: 100 PRB, MCS 26, EVA, 1x2 MRC, dd,
    CFI 2, 4 HARQ rounds, dlsim SNR convention, batch 128, drawn on the
    card; 8 steps at 14.6 dB (corpus test 11's SNR), moved in 1 dB steps
    while round-0 BLER is outside [0.02, 0.98]."""
    cfg = DlsimFadingConfig(mcs=26, n_rb=100, channel="EVA", n_rx=2,
                            est_mode="dd", n_pdcch_symbols=2,
                            n_harq_rounds=4, snr_convention="dlsim",
                            batch=BATCH)
    sim = DlsimFading(cfg, device=dev)
    sim.run_snr(14.6, BATCH, seed=99)            # settle the allocator
    torch.cuda.synchronize()
    snr, tried = 14.6, []
    while True:
        reset_launch_counts()
        t0 = time.perf_counter()
        errs, reach = sim.run_snr(snr, 8 * BATCH, seed=1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        bler = errs / np.maximum(reach, 1)
        tried.append(snr)
        if 0.02 <= bler[0] <= 0.98 or len(tried) == 4:
            break
        snr += 1.0 if bler[0] > 0.98 else -1.0
    steps = 8
    print(f"dd 1x2 100 PRB MCS 26 EVA CFI 2 4 rounds at {snr} dB (dlsim "
          f"convention; tried {tried}): per-round BLER "
          f"{[round(float(x), 4) for x in bler]} (errs {errs.tolist()}, "
          f"reached {reach.tolist()}), round-0 DCI misses {sim.dci_miss}, "
          f"{steps * BATCH / dt:.1f} TB trials/s, "
          f"{steps * BATCH * cfg.n_harq_rounds / dt:.1f} processed "
          f"subframes/s ({steps} steps of {BATCH} x {cfg.n_harq_rounds} "
          f"rounds, {dt:.3f} s)", flush=True)
    print(f"launches over the dd 1x2 runs: {counts}", flush=True)
    if not 0.02 <= bler[0] <= 0.98:
        raise AssertionError(f"dd 1x2 round-0 BLER {bler[0]} outside "
                             "[0.02, 0.98]")
    if not errs[1] < errs[0]:
        raise AssertionError(f"dd 1x2: no HARQ gain {errs}")
    if sim.dci_miss > 0.01 * reach[0]:
        raise AssertionError(f"dd 1x2: {sim.dci_miss} DCI misses")
    if min(counts["mrc_llr"], counts["turbo_half_iter"]) == 0:
        raise AssertionError(f"a kernel of the dd 1x2 path never launched: "
                             f"{counts}")
    return counts, (sim, snr)


# The SISO fidelity anchors (the JAX package's, taken on a TPU): name,
# config, [(SNR, trials, round-0 band as a fraction of the trials)], and
# the condition the later rounds' (errs, bler) must meet, if any.
_ANCHORS = [
    ("test_bler_anchor: MCS 4 estimated-CE waterfall",
     dict(mcs=4, n_rb=25, channel="AWGN", n_harq_rounds=1),
     [(-2.6, 256, (0.9, 1.0)), (-1.8, 256, (0.2, 0.8)),
      (-1.0, 256, (0.0, 0.1))], None),
    ("test_bler_anchor: MCS 4 perfect CE",
     dict(mcs=4, n_rb=25, channel="AWGN", n_harq_rounds=1, perfect_ce=True),
     [(0.6, 256, (0.0, 0.0))], None),
    ("test_bler_anchor: corpus test 5, 6 PRB MCS 4 EVA 1x2 joint",
     dict(mcs=4, n_rb=6, channel="EVA", n_pdcch_symbols=3, n_rx=2,
          n_harq_rounds=2, snr_convention="dlsim", est_mode="joint"),
     [(-1.6, 256, (0.05, 0.37))], lambda e, b: e[1] < e[0]),
    ("test_bler_anchor: ETU HARQ ordering, 6 PRB MCS 10 1x2 joint",
     dict(mcs=10, n_rb=6, channel="ETU", n_pdcch_symbols=3, n_rx=2,
          n_harq_rounds=4, snr_convention="dlsim", est_mode="joint"),
     [(-4.0, 256, (0.6, 1.0))],
     lambda e, b: b[1] < b[0] and b[2] < b[1] and e[3] <= e[2]),
] + [(f"test_bler_anchor: AWGN ladder MCS {m}",
      dict(mcs=m, n_rb=25, channel="AWGN", n_harq_rounds=1,
           est_mode="interp", snr_convention="dlsim"),
      [(lo, 256, (0.8, 1.0)), (mid, 256, (0.15, 0.85)),
       (hi, 256, (0.0, 0.12))], None)
     for m, lo, mid, hi in ((2, -4.4, -4.0, -3.4), (9, 1.7, 2.0, 2.3),
                            (13, 4.7, 5.0, 5.3), (17, 8.1, 8.4, 8.8),
                            (21, 10.9, 11.2, 11.6), (27, 15.5, 15.8, 16.3))
] + [
    ("test_fading: HARQ gain, 6 PRB MCS 10 EVA, 3 rounds",
     dict(mcs=10, n_rb=6, channel="EVA", batch=32, n_turbo_iter=4,
          n_harq_rounds=3),
     [(6.0, 64, (0.0, 1.0))],
     lambda e, b: b[1] < b[0] and (b[2] <= b[1] + 0.1 or e[-1] <= 1)),
    ("test_fading: dd corpus anchor, 50 PRB MCS 26 EVA 1x2 (ref 0.337)",
     dict(mcs=26, n_rb=50, channel="EVA", n_pdcch_symbols=2, n_rx=2,
          n_harq_rounds=1, snr_convention="dlsim", est_mode="dd"),
     [(14.6, 256, (0.0, 0.427))], None),
    ("fading corpus test 6, 50 PRB MCS 15 EVA 1x2 dd (JAX 942/2048)",
     dict(mcs=15, n_rb=50, channel="EVA", n_pdcch_symbols=2, n_rx=2,
          n_harq_rounds=4, snr_convention="dlsim", est_mode="dd"),
     [(4.6, 2048, (0.409, 0.511))], None),
    ("fading corpus test 11, 50 PRB MCS 26 EVA 1x2 dd (JAX 683/2048)",
     dict(mcs=26, n_rb=50, channel="EVA", n_pdcch_symbols=2, n_rx=2,
          n_harq_rounds=4, snr_convention="dlsim", est_mode="dd"),
     [(14.6, 2048, (0.285, 0.382))], None),
    ("Doppler corpus, 25 PRB MCS 10 EVA 200 Hz interp (JAX 524/4096)",
     dict(mcs=10, n_rb=25, channel="EVA", n_harq_rounds=1,
          intra_doppler_hz=200.0, n_turbo_iter=6, batch=256),
     [(8.0, 2048, (0.098, 0.158))], None),
]


def fidelity_anchors(dev) -> None:
    """Every SISO anchor of the JAX package's tests and corpus campaigns,
    with the same configurations, trial counts and bands, on the card
    (batch 128 unless the anchor's campaign used another)."""
    for name, case, points, later in _ANCHORS:
        cfg = DlsimFadingConfig(**{"batch": BATCH, **case})
        sim = DlsimFading(cfg, device=dev)
        t0 = time.perf_counter()
        txt = []
        for snr, n, (lo, hi) in points:
            errs, reach = sim.run_snr(snr, n, seed=0)
            b0 = errs[0] / reach[0]
            txt.append(f"{snr} dB r0 {b0:.4f} ({errs[0]}/{reach[0]}) in "
                       f"[{lo}, {hi}]")
            if not (reach[0] == n and lo <= b0 <= hi):
                raise AssertionError(f"{name} at {snr} dB: round-0 BLER "
                                     f"{b0} ({errs}/{reach}) outside "
                                     f"[{lo}, {hi}]")
            if cfg.n_harq_rounds > 1:
                bler = errs / np.maximum(reach, 1)
                txt[-1] += f", rounds {[round(float(x), 4) for x in bler]}"
                if later is not None and not later(errs, bler):
                    raise AssertionError(f"{name}: later rounds {errs} "
                                         f"of {reach}")
        print(f"anchor {name}: {'; '.join(txt)}; DCI misses {sim.dci_miss}"
              f" ({time.perf_counter() - t0:.1f} s)", flush=True)


def entry_point(dev) -> int:
    """DlsimAwgn at bench.py's second configuration (25 PRB, MCS 4, batch
    512, 8 iterations, 1 dB), then the dlsim command line on the card for
    -g EVA -r 4 and for -x 2, each writing its CSV under build/."""
    sim = DlsimAwgn(DlsimConfig(mcs=4, n_rb=25, batch=512, n_turbo_iter=8),
                    device=dev)
    sim.run_snr(1.0, 512, seed=9)                # settle the allocator
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    errs, trials = sim.run_snr(1.0, 4 * 512, seed=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_turbo = launch_counts()["turbo_half_iter"]
    print(f"DlsimAwgn 25 PRB MCS 4 at 1 dB: BLER {errs / trials:.4f} "
          f"({errs}/{trials}), {trials / dt:.1f} subframes/s (4 steps of "
          f"512, {dt:.3f} s), turbo launches {n_turbo}", flush=True)
    if errs > 0.01 * trials or n_turbo == 0:
        raise AssertionError(f"DlsimAwgn: BLER {errs}/{trials}, turbo "
                             f"launches {n_turbo}")
    os.makedirs("build", exist_ok=True)
    for argv, n_pairs in ((["-g", "EVA", "-r", "4", "-m", "10", "-B", "25",
                            "-s", "6", "-S", "8", "-i", "2"], 4),
                          (["-x", "2", "-m", "10", "-B", "25", "-s", "8",
                            "-S", "8"], 1)):
        path = f"build/dlsim_{'x2' if '-x' in argv else 'eva'}.csv"
        rows = dlsim_main(argv + ["-n", "256", "-b", "128", "-o", path,
                                  "--device", "cuda"])
        with open(path) as f:
            lines = f.read().splitlines()
        for line in lines:
            cols = line.split(";")
            if len(cols) != 4 + 2 * n_pairs + 1 or cols[1] != "10" \
                    or int(cols[5]) != 256:
                raise AssertionError(f"{path}: row {line!r} is not "
                                     f"SNR;MCS;TBS;rate;(err;trials)x"
                                     f"{n_pairs};dci_err")
        if len(lines) != len(rows) or not lines:
            raise AssertionError(f"{path}: {len(lines)} rows for "
                                 f"{len(rows)} sweep points")
        print(f"dlsim {' '.join(argv)} --device cuda: {path} "
              f"{lines}", flush=True)
    return n_turbo


# The uplink's turbo shape at full width: 128 subframes x 8 code blocks of
# K = 5504 decode as 1,024 rows of N = 5,760 (24 windows of W = 240).
UL_TURBO_ROWS = BATCH * 8


def check_turbo_uplink(dev, gen, timings) -> dict:
    """The v2 kernel at the full-width uplink shape against its plain
    version: equal bit for bit."""
    N = TURBO_W * TURBO_NW
    lin = 3.0 * torch.randn(UL_TURBO_ROWS, N, generator=gen, device=dev)
    lp = 3.0 * torch.randn(UL_TURBO_ROWS, N, generator=gen, device=dev)
    lin[:, -TURBO_W // 2:] = 1e4
    lp[:, -TURBO_W // 2:] = 1e4
    got = half_iteration(lin, lp, TURBO_W, TURBO_U)
    want = half_iteration_ref(lin, lp, TURBO_W, TURBO_U)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    kernel = functools.partial(half_iteration, lin, lp, TURBO_W, TURBO_U)
    ms = _time_ms(kernel, 20)
    plain = _time_ms(lambda: half_iteration_ref(lin, lp, TURBO_W, TURBO_U), 3)
    bound = _bound(3 * 4 * UL_TURBO_ROWS * N,
                   TURBO_OPS_PER_POS * UL_TURBO_ROWS * N)
    print(f"turbo_half_iter uplink [{UL_TURBO_ROWS}, {N}] W={TURBO_W} "
          f"U={TURBO_U}: max|diff| {err:.3g} (tol {TURBO_ATOL}); kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound['bound_ms']:.4f} "
          f"ms ({bound['bound_by']})", flush=True)
    if not err <= TURBO_ATOL:
        raise AssertionError(f"turbo kernel at the uplink shape disagrees: "
                             f"{err}")
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain, **bound}
    timings.append(("turbo_half_iter uplink", kernel,
                    "turbo_half_iter_kernel<", row))
    return row


def _v2_only(counts: dict, what: str) -> None:
    """The uplink and the MBSFN paths run the v2 kernel and, as the
    reference's receivers do, the plain demap: neither mrc_llr nor
    demap_llr."""
    if counts["turbo_half_iter"] == 0 or counts["mrc_llr"] \
            or counts["demap_llr"] or counts["turbo_half_iter_v1"]:
        raise AssertionError(f"{what}: launches {counts}")


# The modes of tests/test_torch_ulsim.py and test_torch_ulsim_channels.py,
# at their sizes; the UCI modes again at an SNR where UCI fields fail.
_SMALL_UL = [
    ("data AWGN, 2 rounds", dict(mcs=16, n_rb=6, n_rb_alloc=6,
                                 channel="AWGN", n_harq_rounds=2), None),
    ("UCI RM AWGN", dict(mcs=12, n_rb=6, n_rb_alloc=6, channel="AWGN",
                         uci=UciConfig(o_cqi=8, o_ri=1, o_ack=2)), -6.0),
    ("UCI CC EVA, 2 rounds", dict(mcs=10, n_rb=6, n_rb_alloc=6,
                                  channel="EVA", n_harq_rounds=2,
                                  uci=UciConfig(o_cqi=20, o_ack=1)), -2.0),
    ("hopping type 1 EVA", dict(mcs=10, n_rb=25, n_rb_alloc=6, rb_offset=2,
                                channel="EVA", hopping_bits=0), None),
    ("hopping type 2 AWGN", dict(mcs=10, n_rb=25, n_rb_alloc=4, rb_offset=3,
                                 channel="AWGN", hopping_bits=1, n_sb=2,
                                 n_rb_ho=1), None),
    ("time-domain EVA, 2 rounds", dict(mcs=10, n_rb=6, n_rb_alloc=6,
                                       channel="EVA", n_harq_rounds=2,
                                       time_domain_channel=True), None),
    ("perfect CE, hopping EVA", dict(mcs=10, n_rb=25, n_rb_alloc=6,
                                     rb_offset=2, channel="EVA",
                                     hopping_bits=0, perfect_ce=True), None),
]


def check_small_uplink(dev) -> int:
    """Batch 8, decoder window 240 on both sides: every Ulsim mode, card
    (kernels) against CPU (plain versions) on the same draws; every
    round's flags, the errs and reach, the UCI error counts."""
    B = 8
    reset_launch_counts()
    for name, case, low in _SMALL_UL:
        cfg = UlsimConfig(batch=B, n_turbo_iter=4, decoder_window=240, **case)
        cpu, gpu = Ulsim(cfg, device="cpu"), Ulsim(cfg, device=dev)
        txt = []
        for snr in (30.0,) + ((low,) if low is not None else ()):
            draws = cpu.draw(torch.Generator().manual_seed(21))
            n0 = 10.0 ** (-snr / 10.0)
            a = cpu.trial(*draws, n0, cpu.wiener(snr))
            b = gpu.trial(*draws, n0, gpu.wiener(snr))
            for field in ("ok", "errs", "reach", "uci_errs"):
                x, y = getattr(a, field), getattr(b, field).cpu()
                if not torch.equal(x, y):
                    raise AssertionError(f"small uplink {name} at {snr} dB: "
                                         f"{field} {x} (CPU) vs {y}")
            if snr == 30.0 and (int(a.errs.sum()) or int(a.uci_errs.sum())):
                raise AssertionError(f"small uplink {name} at 30 dB: errs "
                                     f"{a.errs}, UCI errors {a.uci_errs}")
            if snr != 30.0 and not int(a.uci_errs.sum()):
                raise AssertionError(f"small uplink {name} at {snr} dB: no "
                                     "UCI field failed")
            txt.append(f"{snr} dB errs {a.errs.tolist()} reach "
                       f"{a.reach.tolist()} UCI errors {a.uci_errs.tolist()}")
        print(f"small uplink {name} B={B}: {'; '.join(txt)}; equal on card "
              f"and CPU", flush=True)
    counts = launch_counts()
    print(f"launches over the small uplink runs: {counts}", flush=True)
    _v2_only(counts, "small uplink")
    return counts["turbo_half_iter"]


# The full-width uplink: 100 PRB, MCS 20 (16QAM, TBS 43,816, 8 code blocks
# of K = 5,504, the top rate of UE categories 1-4), EVA, estimated DMRS
# channel, 4 HARQ rounds, batch 128, an aperiodic mode 3-0 CQI report at
# 20 MHz (30 bits: the CRC8, convolutional code and Viterbi path) with RI
# and 2 ACK bits. UL_MID_SNR: round 0 fails for 20-80 % of the TBs there
# (found on the card).
UL_FULL = dict(mcs=20, n_rb=100, n_rb_alloc=100, channel="EVA",
               n_harq_rounds=4, batch=BATCH,
               uci=UciConfig(o_cqi=30, o_ri=1, o_ack=2))
UL_MID_SNR = 16.0


def uplink_full_width(dev) -> tuple:
    """30 dB (every TB and UCI field decodes) and UL_MID_SNR (round-0 BLER
    in [0.2, 0.8], a HARQ gain), synced step time and TB trials/s, and the
    v2 kernel's launches in one step."""
    sim = Ulsim(UlsimConfig(**UL_FULL), device=dev)
    sim.run_snr(30.0, BATCH, seed=99)             # settle the allocator
    torch.cuda.synchronize()
    launches, out = 0, {}
    for snr, steps in ((30.0, 2), (UL_MID_SNR, 8)):
        reset_launch_counts()
        t0 = time.perf_counter()
        errs, reach = sim.run_snr(snr, steps * BATCH, seed=1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        _v2_only(counts, f"uplink full width at {snr} dB")
        launches += counts["turbo_half_iter"]
        bler = errs / np.maximum(reach, 1)
        print(f"uplink 100 PRB MCS 20 EVA 4 rounds UCI 30+1+2 at {snr} dB: "
              f"per-round BLER {[round(float(x), 4) for x in bler]} (errs "
              f"{errs.tolist()}, reached {reach.tolist()}), UCI errors "
              f"[cqi, ri, ack] {sim.uci_errs.tolist()} of {reach[0]}; "
              f"{dt / steps * 1e3:.1f} ms a step, {steps * BATCH / dt:.1f} TB "
              f"trials/s ({steps} steps of {BATCH} x 4 rounds, {dt:.3f} s); "
              f"turbo launches {counts['turbo_half_iter']}", flush=True)
        out[snr] = (errs, reach, sim.uci_errs.copy())
    errs, reach, uci = out[30.0]
    if int(errs.sum()) or int(uci.sum()):
        raise AssertionError(f"uplink at 30 dB: errs {errs}, UCI {uci}")
    errs, reach, uci = out[UL_MID_SNR]
    if not (0.2 <= errs[0] / reach[0] <= 0.8 and errs[1] < errs[0]):
        raise AssertionError(f"uplink at {UL_MID_SNR} dB: round-0 BLER "
                             f"{errs[0] / reach[0]} outside [0.2, 0.8] or no "
                             f"HARQ gain {errs}")
    gen = torch.Generator(device=dev).manual_seed(3)
    W = sim.wiener(UL_MID_SNR)
    reset_launch_counts()
    sim.step(gen, 10.0 ** (-UL_MID_SNR / 10.0), W)
    torch.cuda.synchronize()
    per_step = launch_counts()["turbo_half_iter"]
    print(f"uplink at {UL_MID_SNR} dB: the v2 kernel launches {per_step} "
          "times in one step", flush=True)
    return launches, per_step, (sim, UL_MID_SNR)


# tests/test_bler_anchor.py's uplink ladder rows: (mcs, channel, FIR,
# below, mid and above the knee) at 25 PRB, 128 trials each; and the
# ulsim_campaign.json points (taken on a TPU, 2,048 trials or more) near
# each row's mid-knee, printed beside the port's 2,048 trials.
_UL_ANCHORS = [(4, "AWGN", False, -2.6, -1.8, -1.0),
               (16, "AWGN", False, 7.0, 7.6, 8.3),
               (10, "EVA", True, 2.0, 7.5, 14.5)]
_UL_CAMPAIGN = [("awgn4", -2.0), ("awgn10", 2.75), ("awgn16", 7.5),
                ("eva", 5.5)]


def uplink_anchors(dev) -> int:
    reset_launch_counts()
    for mcs, channel, tdc, lo, mid, hi in _UL_ANCHORS:
        sim = Ulsim(UlsimConfig(mcs=mcs, n_rb=25, n_rb_alloc=25,
                                channel=channel, batch=BATCH,
                                time_domain_channel=tdc), device=dev)
        res = [sim.run_snr(snr, 128, seed=0) for snr in (lo, mid, hi)]
        b = [e[0] / r[0] for e, r in res]
        print(f"uplink anchor MCS {mcs} {channel}{' FIR' if tdc else ''}: "
              f"round-0 BLER {b[0]:.4f} at {lo} dB (>= 0.7), {b[1]:.4f} at "
              f"{mid} dB (in [0.1, 0.9]), {b[2]:.4f} at {hi} dB (<= 0.13)",
              flush=True)
        if not (b[0] >= 0.7 and 0.1 <= b[1] <= 0.9 and b[2] <= 0.13):
            raise AssertionError(f"uplink anchor MCS {mcs} {channel}: {b}")
    with open("ulsim_campaign.json") as f:
        campaign = json.load(f)
    for tag, snr in _UL_CAMPAIGN:
        row = campaign[tag]
        sim = Ulsim(UlsimConfig(mcs=row["mcs"], n_rb=row["n_rb"],
                                n_rb_alloc=row["n_rb_alloc"],
                                channel=row["channel"], batch=256,
                                time_domain_channel=row[
                                    "time_domain_channel"]), device=dev)
        errs, reach = sim.run_snr(snr, 2048, seed=0)
        ref = row["bler0"][row["snr"].index(snr)]
        port = errs[0] / reach[0]
        sd = np.sqrt(max(ref * (1 - ref), 1e-12) * 2 / 2048)
        print(f"ulsim_campaign {tag} at {snr} dB: round-0 BLER {port:.4f} "
              f"({errs[0]}/{reach[0]}) on the card, {ref:.4f} in the "
              f"campaign (JAX, taken on a TPU); difference "
              f"{(port - ref) / sd:+.2f} sd of a two-sample binomial",
              flush=True)
    counts = launch_counts()
    print(f"launches over the uplink anchors: {counts}", flush=True)
    _v2_only(counts, "uplink anchors")
    return counts["turbo_half_iter"]


# tests/test_pucch.py's operating points: (format, SNR, least and most
# error rate over 128 trials)
_PUCCH_POINTS = [("1a", -8.0, 0.0, 0.02), ("1a", -20.0, 0.1, 1.0),
                 ("2", -2.0, 0.0, 0.05), ("2a", 0.0, 0.0, 0.05),
                 ("2b", 0.0, 0.0, 0.05)]


def pucch_points(dev) -> None:
    """Pucchsim on the card at the operating points, card against CPU on
    the same draws for each format, and the pucchsim command line."""
    for fmt, snr, lo, hi in _PUCCH_POINTS:
        sim = Pucchsim(PucchsimConfig(fmt=fmt, batch=128), device=dev)
        r = sim.run_snr(snr, n_batches=1)
        cpu = Pucchsim(PucchsimConfig(fmt=fmt, batch=128), device="cpu")
        draws = cpu.draw(torch.Generator().manual_seed(4))
        n0 = 10.0 ** (-snr / 10.0)
        same = torch.equal(cpu.trial(*draws, n0), sim.trial(*draws, n0).cpu())
        print(f"pucchsim {fmt} at {snr} dB: error rate {r['err_rate']:.4f} "
              f"over {r['trials']} trials (in [{lo}, {hi}]); card equals CPU"
              f" on the same draws: {same}", flush=True)
        if not (lo <= r["err_rate"] <= hi and same):
            raise AssertionError(f"pucchsim {fmt} at {snr} dB: {r}, card = "
                                 f"CPU {same}")
    rows = pucchsim_main(["-f", "2b", "-s", "-4", "-S", "0", "-n", "1",
                          "--device", "cuda"])
    if len(rows) != 3:
        raise AssertionError(f"pucchsim command line: {rows}")


# ----------------------------------------------- control and sync channels --

def _equal(name: str, cpu, gpu) -> None:
    """Each pair of tensors equal on the CPU and the card."""
    for i, (a, b) in enumerate(zip(cpu, gpu)):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"small {name}: output {i} {a} (CPU) vs "
                                 f"{b.cpu()} (card)")


def _no_kernel(what: str) -> None:
    """The control and sync paths run no hand-written kernel: their LLRs
    go through the plain demap, as the reference's do."""
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"{what}: launches {counts}")


def _scan_captures(n_rb: int, B: int, snr_db: float, seed: int):
    """[B, capture_len] captures of cell 3 * 57 + 1: the Syncsim waveform at
    random offsets, the second half of the batch 1 subcarrier off, AWGN;
    made on the CPU from a seed. Returns (captures, the cell's Syncsim)."""
    sim = Syncsim(SyncsimConfig(n_rb=n_rb, nid1=57, nid2=1), device="cpu")
    gen = torch.Generator().manual_seed(seed)
    L = sim.search.capture_len
    wave = sim.subframe_t
    cap = torch.zeros(B, L, dtype=torch.complex64)
    offs = torch.randint(0, sim.max_off, (B,), generator=gen)
    for b, o in enumerate(offs.tolist()):
        cap[b, o:o + wave.shape[0]] = wave
    t = torch.arange(L)
    cap[B // 2:] *= torch.exp(2j * np.pi / sim.fp.n_fft * t)
    n = torch.randn(B, L, 2, generator=gen) \
        * float(np.sqrt(0.5 * 10.0 ** (-snr_db / 10.0)))
    return cap + torch.complex(n[..., 0], n[..., 1]), sim


# Prachsim on every path at small size: (name, config, [SNR]); the second
# SNR of a pair is one where some preambles are missed
_SMALL_PRACH = [("RE level", dict(), (-12.0, -21.0)),
                ("restricted", dict(root_u=500, ncs=15, high_speed=True),
                 (-18.0,)),
                ("format 4", dict(root_u=3, ncs=15, fmt=4, max_delay=6),
                 (-8.0,)),
                ("time domain", dict(time_domain=True, n_fft=256),
                 (-8.0, -22.0))]


def check_small_control(dev) -> int:
    """Phase 22: every new simulator at 6 or 25 PRB, card against CPU on
    the same draws (made on the CPU from a seed): every decision and
    error count equal, soft values within the tolerance printed. Returns
    the v2 launches of Mbmssim's runs."""
    B = 16
    reset_launch_counts()
    cfg = PdcchsimConfig(n_rb=25, n_pdcch=3, L=4, batch=B)
    cpu, gpu = Pdcchsim(cfg, device="cpu"), Pdcchsim(cfg, device=dev)
    txt = []
    for snr in (0.0, -8.0):
        noise = cpu.draw(torch.Generator().manual_seed(31))
        n0 = 10.0 ** (-snr / 10.0)
        a = cpu.trial(noise, n0, cpu.wiener(snr))
        _equal(f"Pdcchsim {snr} dB", a, gpu.trial(noise, n0, gpu.wiener(snr)))
        txt.append(f"{snr} dB CFI ok {int(a[0].sum())}/{B}, DCI ok "
                   f"{int(a[1].sum())}/{B}")
    print(f"small Pdcchsim 25 PRB CFI 3 L=4 ({len(cpu.candidates)} "
          f"candidates): {'; '.join(txt)}; equal on card and CPU", flush=True)

    txt = []
    for case, snrs in ((dict(), (-2.0, -8.0)), (dict(perfect_ce=True),
                                                (-8.0,))):
        cfg = PbchsimConfig(n_rb=25, n_id_cell=7, frame_phase=2, batch=B,
                            **case)
        cpu, gpu = Pbchsim(cfg, device="cpu"), Pbchsim(cfg, device=dev)
        for snr in snrs:
            noise = cpu.draw(torch.Generator().manual_seed(32))
            n0 = 10.0 ** (-snr / 10.0)
            a = cpu.trial(noise, n0, cpu.wiener(snr))
            _equal(f"Pbchsim {case} {snr} dB", (a,),
                   (gpu.trial(noise, n0, gpu.wiener(snr)),))
            txt.append(f"{'perfect CE ' if case else ''}{snr} dB "
                       f"{int(a.sum())}/{B}")
    print(f"small Pbchsim 25 PRB: MIB decoded {'; '.join(txt)}; equal on "
          "card and CPU", flush=True)

    worst = 0.0
    txt = []
    for cfo, snr in ((0.0, 0.0), (0.0, -12.0), (0.2, 10.0)):
        cfg = SyncsimConfig(n_rb=25, nid1=57, nid2=1, cfo_scs=cfo, batch=8)
        cpu, gpu = Syncsim(cfg, device="cpu"), Syncsim(cfg, device=dev)
        draws = cpu.draw(torch.Generator().manual_seed(33))
        n0 = 10.0 ** (-snr / 10.0)
        a, b = cpu.trial(*draws, n0), gpu.trial(*draws, n0)
        _equal(f"Syncsim CFO {cfo} {snr} dB", a[:2], b[:2])
        found = a[1] == 0
        if found.any():
            worst = max(worst, (a[2] - b[2].cpu())[found].abs().max().item())
        txt.append(f"CFO {cfo} at {snr} dB: cell found {int(a[0].sum())}/8")
    print(f"small Syncsim 25 PRB: {'; '.join(txt)}; nid_ok and pos_err equal "
          f"on card and CPU, CFO estimates max |diff| {worst:.3g} scs (must "
          "be <= 1e-3)", flush=True)
    if not worst <= 1e-3:
        raise AssertionError(f"small Syncsim: CFO estimates differ by {worst}")

    cap, _ = _scan_captures(25, 8, 0.0, 34)
    hyps = (-1.0, 0.0, 1.0)
    a = CarrierScan(ScanConfig(n_rb=25, freq_hyps=hyps), device="cpu").scan(
        cap)
    b = CarrierScan(ScanConfig(n_rb=25, freq_hyps=hyps), device=dev).scan(cap)
    keys = ("nid1", "nid2", "pss_pos", "half", "hyp", "coarse_cfo")
    _equal("CarrierScan", [a[k] for k in keys], [b[k] for k in keys])
    d = (a["fine_cfo"] - b["fine_cfo"].cpu()).abs().max().item()
    print(f"small CarrierScan 25 PRB, 3 hypotheses, B=8 at 0 dB: coarse CFO "
          f"{a['coarse_cfo'].tolist()}, cell "
          f"{(3 * a['nid1'] + a['nid2']).tolist()}; equal on card and CPU, "
          f"fine CFO max |diff| {d:.3g} scs (must be <= 1e-3)", flush=True)
    if not d <= 1e-3:
        raise AssertionError(f"small CarrierScan: fine CFO differs by {d}")

    txt = []
    for name, case, snrs in _SMALL_PRACH:
        cfg = PrachsimConfig(batch=32, **case)
        cpu, gpu = Prachsim(cfg, device="cpu"), Prachsim(cfg, device=dev)
        for snr in snrs:
            draws = cpu.draw(torch.Generator().manual_seed(35))
            n0 = 10.0 ** (-snr / 10.0)
            a = cpu.trial(*draws, n0)
            _equal(f"Prachsim {name} {snr} dB", a, gpu.trial(*draws, n0))
            txt.append(f"{name} {snr} dB det {int(a[0].sum())}/32 false "
                       f"{int(a[2].sum())}")
    print(f"small Prachsim: {'; '.join(txt)}; det, delay_ok and n_false "
          "equal on card and CPU", flush=True)
    _no_kernel("small control and sync inputs")

    cfg = MbmssimConfig(mcs=4, n_rb=25, n_sfn_cells=3, max_delay_frac=0.6,
                        n_turbo_iter=6, batch=8, decoder_window=240)
    cpu, gpu = Mbmssim(cfg, device="cpu"), Mbmssim(cfg, device=dev)
    txt = []
    for snr in (20.0, 0.0):
        draws = cpu.draw(torch.Generator().manual_seed(36))
        n0 = 10.0 ** (-snr / 10.0)
        a = cpu.trial(*draws, n0)
        _equal(f"Mbmssim {snr} dB", a, gpu.trial(*draws, n0))
        txt.append(f"{snr} dB TBs ok {int(a[0].sum())}/8 bit errors "
                   f"{a[1].tolist()}")
    counts = launch_counts()
    print(f"small Mbmssim 25 PRB MCS 4, 3 SFN cells, estimated CE: "
          f"{'; '.join(txt)}; equal on card and CPU; launches {counts}",
          flush=True)
    _v2_only(counts, "small Mbmssim")
    return counts["turbo_half_iter"]


# The MBSFN full width: 100 PRB extended CP holds 10,200 PMCH REs; MCS 22
# (64QAM, TBS 46,888, rate 0.77, 8 code blocks of K = 5,888) is the top MCS
# that fits (MCS 26 would be rate 1.008). At batch 128 the decoder runs v2
# at 1,024 rows of N = 6,000 (25 windows of W = 240).
MBMS_FULL = dict(mcs=22, n_rb=100, n_sfn_cells=3, max_delay_frac=0.8,
                 n_turbo_iter=8, batch=BATCH)
MBMS_TURBO_ROWS, MBMS_TURBO_N = BATCH * 8, 6000
# With the channel known, BLER is in [0.05, 0.5] at MBMS_MID_SNR (found by
# a scan on the card) and every TB decodes at MBMS_HIGH_SNR. With the MBSFN
# RS estimate the reference decodes no TB at these delays (the estimate
# takes each subcarrier from comb sample k // 2, so an odd subcarrier reads
# its neighbour's phase, up to 2 pi 0.8 CP / n_fft = 1.26 rad off; and the
# smoother ignores symbol 6's comb offset): a BLER floor the port keeps.
MBMS_MID_SNR, MBMS_HIGH_SNR = 22.0, 40.0
MBMS_EST_FLOOR = 0.8


def check_turbo_mbsfn(dev, gen, timings) -> dict:
    """Phase 23: the v2 kernel at the MBSFN full-width shape against its
    plain version: equal bit for bit."""
    lin = 3.0 * torch.randn(MBMS_TURBO_ROWS, MBMS_TURBO_N, generator=gen,
                            device=dev)
    lp = 3.0 * torch.randn(MBMS_TURBO_ROWS, MBMS_TURBO_N, generator=gen,
                           device=dev)
    lin[:, -TURBO_W // 2:] = 1e4
    lp[:, -TURBO_W // 2:] = 1e4
    got = half_iteration(lin, lp, TURBO_W, TURBO_U)
    want = half_iteration_ref(lin, lp, TURBO_W, TURBO_U)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    kernel = functools.partial(half_iteration, lin, lp, TURBO_W, TURBO_U)
    ms = _time_ms(kernel, 20)
    plain = _time_ms(lambda: half_iteration_ref(lin, lp, TURBO_W, TURBO_U), 3)
    n_pos = MBMS_TURBO_ROWS * MBMS_TURBO_N
    bound = _bound(3 * 4 * n_pos, TURBO_OPS_PER_POS * n_pos)
    print(f"turbo_half_iter MBSFN [{MBMS_TURBO_ROWS}, {MBMS_TURBO_N}] "
          f"W={TURBO_W} U={TURBO_U}: max|diff| {err:.3g} (tol {TURBO_ATOL}); "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})", flush=True)
    if not err <= TURBO_ATOL:
        raise AssertionError(f"turbo kernel at the MBSFN shape disagrees: "
                             f"{err}")
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain, **bound}
    timings.append(("turbo_half_iter MBSFN", kernel, "turbo_half_iter_kernel<",
                    row))
    return row


def _mbms_run(sim, snr: float, steps: int, what: str) -> tuple:
    """BLER, step time and v2 launches of `steps` steps at `snr`, with the
    launch counts set to 0 just before and read just after."""
    reset_launch_counts()
    t0 = time.perf_counter()
    errs, trials = sim.run_snr(snr, steps * BATCH, seed=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    _v2_only(counts, f"Mbmssim full width {what} at {snr} dB")
    print(f"Mbmssim 100 PRB MCS 22, 3 SFN cells, delays to 0.8 ECP, {what} "
          f"at {snr} dB: BLER {errs / trials:.4f} ({errs}/{trials}), "
          f"{dt / steps * 1e3:.1f} ms a step, {trials / dt:.1f} TB trials/s "
          f"({steps} steps of {BATCH}, {dt:.3f} s); turbo launches "
          f"{counts['turbo_half_iter']}", flush=True)
    return errs / trials, counts["turbo_half_iter"]


def _per_step_launches(sim, snr: float) -> int:
    gen = torch.Generator(device=sim.device).manual_seed(3)
    reset_launch_counts()
    sim.step(gen, 10.0 ** (-snr / 10.0))
    torch.cuda.synchronize()
    return launch_counts()["turbo_half_iter"]


def mbms_full_width(dev) -> tuple:
    """Phase 24: Mbmssim at full width. Channel known: every TB decodes at
    MBMS_HIGH_SNR, BLER in [0.05, 0.5] at MBMS_MID_SNR (moved in 1 dB steps
    while outside, at most 4 tries). MBSFN RS estimate: the reference's
    floor, BLER at least MBMS_EST_FLOOR at MBMS_HIGH_SNR. Step times, TB
    trials/s and the v2 kernel's launches in one step of each."""
    genie = Mbmssim(MbmssimConfig(perfect_ce=True, **MBMS_FULL), device=dev)
    est = Mbmssim(MbmssimConfig(**MBMS_FULL), device=dev)
    genie.run_snr(MBMS_HIGH_SNR, BATCH, seed=99)    # settle the allocator
    torch.cuda.synchronize()
    bler, launches = _mbms_run(genie, MBMS_HIGH_SNR, 2, "channel known")
    if bler:
        raise AssertionError(f"Mbmssim, channel known, at {MBMS_HIGH_SNR} "
                             f"dB: BLER {bler}")
    snr, tried = MBMS_MID_SNR, []
    while True:
        bler, n = _mbms_run(genie, snr, 8, "channel known")
        launches += n
        tried.append(snr)
        if 0.05 <= bler <= 0.5 or len(tried) == 4:
            break
        snr += 1.0 if bler > 0.5 else -1.0
    if not 0.05 <= bler <= 0.5:
        raise AssertionError(f"Mbmssim, channel known: BLER {bler} at {snr} "
                             f"dB (tried {tried}) outside [0.05, 0.5]")
    floor, n = _mbms_run(est, MBMS_HIGH_SNR, 2, "MBSFN RS estimate")
    launches += n
    if floor < MBMS_EST_FLOOR:
        raise AssertionError(f"Mbmssim, MBSFN RS estimate, at "
                             f"{MBMS_HIGH_SNR} dB: BLER {floor}, below the "
                             f"reference's floor {MBMS_EST_FLOOR}")
    per_step = {"channel known": _per_step_launches(genie, snr),
                "MBSFN RS estimate": _per_step_launches(est, MBMS_HIGH_SNR)}
    print(f"Mbmssim (channel known at {snr} dB, tried {tried}; estimate at "
          f"{MBMS_HIGH_SNR} dB): the v2 kernel launches {per_step} times in "
          "one step", flush=True)
    return launches, per_step["channel known"], ((genie, snr),
                                                 (est, MBMS_HIGH_SNR))


# prach_roc.json's configurations: (tag, config); threshold 15
_PRACH_ROC = [("fmt0_ncs13", dict()), ("fmt0_ncs13_lowsnr", dict()),
              ("restricted_ncs15", dict(root_u=500, ncs=15, high_speed=True,
                                        max_delay=10)),
              ("fmt4_ncs15", dict(root_u=3, ncs=15, fmt=4, max_delay=6))]


def _sd3(ref: float, n: int) -> float:
    """3 sd of the difference of two binomial rates over n trials each, at
    least one event's worth."""
    return 3.0 * np.sqrt(max(ref * (1 - ref), 1.0 / n) * 2.0 / n)


def control_anchors(dev) -> int:
    """Phase 25: the reference's anchors on the card, with their
    configurations, trial counts and bands: tests/test_pbch_pdcch_anchor.py
    (PBCH at 25 PRB; PDCCH at 100 PRB, CFI 2, L = 4 and 8, batch 128),
    tests/test_sync_pbch.py's cell-search and CFO points, prach_roc.json's
    four configurations at threshold 15 (within 3 sd of the JSON over as
    many occasions), tests/test_mbms.py's two link points."""
    reset_launch_counts()
    sim = Pbchsim(PbchsimConfig(batch=256), device=dev)
    txt = []
    for snr, ref in ((-6.2, 0.499), (-4.2, 0.088), (-2.2, 0.0092)):
        b = sim.run_snr(snr, n_batches=2)["bler"]
        txt.append(f"{snr} dB {b:.4f} (<= {ref} + 0.05)")
        if not b <= ref + 0.05:
            raise AssertionError(f"PBCH anchor at {snr} dB: {b}")
    b7, b5 = (sim.run_snr(s, n_batches=2)["bler"] for s in (-7.0, -5.0))
    print(f"anchor PBCH 25 PRB, 512 trials: {'; '.join(txt)}; -7.0 dB "
          f"{b7:.4f} (in [0.28, 0.58]), -5.0 dB {b5:.4f} (<= 0.10)",
          flush=True)
    if not (0.28 <= b7 <= 0.58 and b5 <= 0.10):
        raise AssertionError(f"PBCH waterfall anchor: {b7}, {b5}")

    for L, snr, ref, (w_snr, lo, hi) in ((4, -0.4, 0.49, (-3.0, 0.02, 0.17)),
                                         (8, -2.0, 0.27, (-6.0, 0.05, 0.28))):
        sim = Pdcchsim(PdcchsimConfig(n_rb=100, n_pdcch=2, L=L, batch=BATCH),
                       device=dev)
        t0 = time.perf_counter()
        e = sim.run_snr(snr, n_batches=2)["dci_err"]
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 2
        w = sim.run_snr(w_snr, n_batches=4)["dci_err"]
        print(f"anchor PDCCH 100 PRB CFI 2 L={L} ({len(sim.candidates)} "
              f"candidates): {snr} dB DCI err {e:.4f} (<= {min(ref, 0.05)}), "
              f"{w_snr} dB {w:.4f} (in [{lo}, {hi}]); {dt * 1e3:.1f} ms a "
              f"step of {BATCH}", flush=True)
        if not (e <= min(ref, 0.05) and lo <= w <= hi):
            raise AssertionError(f"PDCCH anchor L={L}: {e}, {w}")

    r = Syncsim(SyncsimConfig(n_rb=6, nid1=11, nid2=2, batch=16),
                device=dev).run_snr(3.0, n_batches=1)
    c = Syncsim(SyncsimConfig(n_rb=6, batch=16, cfo_scs=0.2),
                device=dev).run_snr(10.0, n_batches=1)
    print(f"anchor cell search 6 PRB at 3 dB: det {r['det_rate']:.3f} (>= "
          f"0.9), timing errors {r['timing_err_rate']:.3f} (<= 0.1); CFO 0.2 "
          f"at 10 dB: mean |cfo| {c['mean_abs_cfo']:.4f} (0.2 +- 0.07)",
          flush=True)
    if not (r["det_rate"] >= 0.9 and r["timing_err_rate"] <= 0.1
            and abs(c["mean_abs_cfo"] - 0.2) < 0.07):
        raise AssertionError(f"cell-search anchors: {r}, {c}")
    _no_kernel("PBCH, PDCCH and cell-search anchors")

    with open("prach_roc.json") as f:
        roc = json.load(f)
    for tag, case in _PRACH_ROC:
        ref = roc[tag]
        row = next(x for x in ref["rows"] if x["threshold"] == 15.0)
        n_batches = ref["occasions"] // 256
        sim = Prachsim(PrachsimConfig(batch=256, **case), device=dev)
        got = sim.roc(ref["snr_db"], [15.0], n_batches=n_batches)[0]
        n = n_batches * 256
        bands = {k: _sd3(row[k], n) for k in ("det_rate", "fa_per_occasion")}
        print(f"anchor prach_roc {tag} at {ref['snr_db']} dB, threshold 15, "
              f"{n} occasions: det {got['det_rate']:.5f} (JSON "
              f"{row['det_rate']:.5f} +- {bands['det_rate']:.5f}), fa/occasion"
              f" {got['fa_per_occasion']:.5f} (JSON {row['fa_per_occasion']:.5f}"
              f" +- {bands['fa_per_occasion']:.5f})", flush=True)
        for k, band in bands.items():
            if abs(got[k] - row[k]) > band:
                raise AssertionError(f"prach_roc {tag}: {k} {got[k]} vs "
                                     f"{row[k]} +- {band}")
    _no_kernel("prach_roc anchors")

    e1, t1 = Mbmssim(MbmssimConfig(mcs=4, n_rb=6, n_sfn_cells=1,
                                   max_delay_frac=0.0, batch=16,
                                   n_turbo_iter=6, perfect_ce=True),
                     device=dev).run_snr(25.0, 16)
    e3, t3 = Mbmssim(MbmssimConfig(mcs=4, n_rb=25, n_sfn_cells=3,
                                   max_delay_frac=0.6, batch=16,
                                   n_turbo_iter=6), device=dev).run_snr(20.0,
                                                                        16)
    print(f"anchor test_mbms: 1 cell perfect CE 25 dB {e1}/{t1} errors (<= "
          f"1); 3 SFN cells estimated CE 20 dB {e3}/{t3} (<= half)",
          flush=True)
    if not (e1 <= 1 and e3 <= t3 * 0.5):
        raise AssertionError(f"test_mbms anchors: {e1}, {e3}")
    counts = launch_counts()
    _v2_only(counts, "test_mbms anchors")
    return counts["turbo_half_iter"]


def _timed_steps(fn, n: int) -> float:
    """Seconds a call of fn, host clock around n calls and a synchronize,
    after one call to settle."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n


def sync_prach_20mhz(dev) -> list:
    """Phase 26: Syncsim and CarrierScan at 100 PRB (a 155,648-sample
    capture, FFTs of 262,144; 5 frequency hypotheses) and the time-domain
    Prachsim at n_fft 2048, n_rb_ul 100 (N = 24,576, k0 = -7,187):
    detection rates, step times; returns the steps phase 16 profiles."""
    reset_launch_counts()
    out = []
    for cfo, snr in ((0.0, 0.0), (0.2, 10.0)):
        sim = Syncsim(SyncsimConfig(n_rb=100, nid1=57, nid2=1, cfo_scs=cfo,
                                    batch=32), device=dev)
        r = sim.run_snr(snr, n_batches=4, seed=1)
        gen = torch.Generator(device=dev).manual_seed(2)
        n0 = 10.0 ** (-snr / 10.0)
        dt = _timed_steps(lambda: sim.step(gen, n0), 3)
        print(f"Syncsim 100 PRB CFO {cfo} at {snr} dB, 128 trials: det "
              f"{r['det_rate']:.4f}, timing errors {r['timing_err_rate']:.4f},"
              f" mean |cfo| {r['mean_abs_cfo']:.4f} scs; {dt * 1e3:.1f} ms a "
              f"step of 32 ({32 / dt:.1f} captures/s)", flush=True)
        # without CFO the cell is found; with it, the CFO estimate holds
        # (the coherent SSS detection, as the reference's, loses the cell
        # to the phase the CFO turns between the SSS and PSS symbols)
        if (r["det_rate"] < 0.9 if not cfo
                else abs(r["mean_abs_cfo"] - cfo) > 0.07):
            raise AssertionError(f"Syncsim 100 PRB CFO {cfo}: {r}")
        out.append((f"Syncsim 100 PRB CFO {cfo}, step of 32",
                    functools.partial(sim.step, gen, n0)))
    cap, ssim = _scan_captures(100, 16, 0.0, 37)
    scan = CarrierScan(ScanConfig(n_rb=100), device=dev)
    cap = cap.to(dev)
    res = scan.scan(cap)
    want = torch.tensor([0.0] * 8 + [1.0] * 8)
    right = ((res["coarse_cfo"].cpu() == want)
             & (res["nid1"].cpu() == 57) & (res["nid2"].cpu() == 1))
    dt = _timed_steps(lambda: scan.scan(cap), 3)
    print(f"CarrierScan 100 PRB, 5 hypotheses, 16 captures at 0 dB: cell and "
          f"coarse CFO right {int(right.sum())}/16, fine CFO "
          f"{res['fine_cfo'].abs().max().item():.4f} scs at most; "
          f"{dt * 1e3:.1f} ms a scan", flush=True)
    if int(right.sum()) < 14:
        raise AssertionError(f"CarrierScan 100 PRB: {res}")
    out.append(("CarrierScan 100 PRB, 16 captures", functools.partial(
        scan.scan, cap)))
    sim = Prachsim(PrachsimConfig(time_domain=True, n_fft=2048, n_rb_ul=100),
                   device=dev)
    r = sim.run_snr(-12.0, n_batches=4, seed=1)
    gen = torch.Generator(device=dev).manual_seed(2)
    n0 = 10.0 ** 1.2
    dt = _timed_steps(lambda: sim.step(gen, n0), 3)
    print(f"Prachsim time domain n_fft 2048 n_rb_ul 100 at -12 dB/bin, 256 "
          f"trials: det {r['det_rate']:.4f}, delay ok {r['delay_ok_rate']:.4f}"
          f", false/trial {r['false_per_trial']:.4f}; {dt * 1e3:.1f} ms a step"
          f" of 64", flush=True)
    if r["det_rate"] < 0.95 or r["delay_ok_rate"] < 0.9:
        raise AssertionError(f"Prachsim 20 MHz: {r}")
    out.append(("Prachsim time domain 20 MHz, step of 64",
                functools.partial(sim.step, gen, n0)))
    _no_kernel("sync and PRACH at 20 MHz")
    return out


# ------------------------------------- per-TTI procedures and their sims --

def _small_fullsim(dev, case: dict, snr: float, seed: int):
    """FullChainSim at 25 PRB, batch 4, on the CPU and the card on the same
    draws; every round's flags and the trial's counts must be equal."""
    cfg = FullsimConfig(n_rb=25, batch=4, n_turbo_iter=4, decoder_window=240,
                        **case)
    cpu, gpu = FullChainSim(cfg, device="cpu"), FullChainSim(cfg, device=dev)
    draws = cpu.draw(torch.Generator().manual_seed(seed))
    n0 = 10.0 ** (-snr / 10.0)
    a = cpu.trial(*draws, n0, cpu.ue.make_wiener(n0))
    b = gpu.trial(*draws, n0, gpu.ue.make_wiener(n0))
    for r, (ra, rb) in enumerate(zip(a.rounds, b.rounds)):
        _equal(f"FullChainSim {case} round {r}", ra[:4], rb[:4])
    _equal(f"FullChainSim {case}", a[1:], b[1:])
    return a


def _small_ue_rx(dev) -> dict:
    """UeRx.receive, TM 2 (the 1A and the format-1 size hypotheses, both
    DCIs sent), 25 PRB CFI 2 MCS 4, batch 4, 30 dB: every decision equal on
    the card and the CPU."""
    cell = CellConfig(n_rb=25, n_pdcch=2, mcs=4)
    enb = EnbTx(cell, device="cpu")
    c1 = next(c for c in ue_search_candidates(enb.crm.n_cce, cell.rnti,
                                              cell.subframe)
              if c.cce_offset >= cell.dci_L)
    f1 = pack_dci_format1(25, (1 << n_rbg(25)[0]) - 1, 9, 2, 1, 0)
    enb.set_dcis([(enb.dci_payload, cell.rnti, cell.dci_L, 0),
                  (f1, cell.rnti, c1.L, c1.cce_offset)])
    ues = {d: UeRx(cell, n_turbo_iter=4, tm=2, device=d, decoder_window=240)
           for d in ("cpu", dev)}
    codec, ue = ues["cpu"].codec, ues["cpu"]
    gen = torch.Generator().manual_seed(21)
    tb = torch.randint(0, 2, (4, codec.cfg.tbs), generator=gen,
                       dtype=torch.int32)
    e = scramble_bits(codec.encode(tb), ue.scr_seq)
    t = enb.data_waveform(map_symbols(e, codec.cfg.Qm),
                          ack_bits=torch.tensor([0, 1, 1, 0]))
    n0 = 10.0 ** -3.0
    noise = torch.randn(4, t.shape[1], 2, generator=gen)
    rgrid = ofdm_demodulate(t + n0 ** 0.5 / 2 ** 0.5 * torch.complex(
        noise[..., 0], noise[..., 1]), enb.fp)
    out = {d: u.receive(rgrid.to(d), n0, u.make_wiener(n0))
           for d, u in ues.items()}
    a, b = out["cpu"], out[dev]
    keys = ("cfi_hat", "dci_found", "dci_payload", "tb", "tb_ok",
            "phich_ack")
    _equal("UeRx TM2", [a[k] for k in keys], [b[k] for k in keys])
    for fmt in ("1a", "1"):
        _equal(f"UeRx TM2 format {fmt}", a["dci"][fmt], b["dci"][fmt])
    if not (bool(a["tb_ok"].all()) and bool(a["dci"]["1"][0].all())
            and bool((a["cfi_hat"] == 2).all())):
        raise AssertionError(f"UeRx TM2 at 30 dB: {a}")
    return a


def _small_uplink_sched(dev) -> None:
    """UeTx + EnbRx: the PUSCH with an SRS (25 PRB MCS 6, 20 PRB, 12 dB) and
    PUCCH format 1a (6 dB), batch 4, card against CPU on one waveform."""
    kw = dict(n_rb=25, mcs=6, n_rb_alloc=20, n_turbo_iter=4,
              decoder_window=240, srs=SrsConfig(n_rb=25, srs_bw_rb=20))
    txs = {d: UeTx(UeUlConfig(**kw), d) for d in ("cpu", dev)}
    gen = torch.Generator().manual_seed(22)
    tb = torch.randint(0, 2, (4, txs["cpu"].ulsch.tbs), generator=gen,
                       dtype=torch.int32)
    wave = txs["cpu"].pusch_subframe(tb)
    n0 = 10.0 ** -1.2
    noise = torch.randn(4, wave.shape[1], 2, generator=gen)
    rx = wave + (n0 / 2) ** 0.5 * torch.complex(noise[..., 0], noise[..., 1])
    out = {d: EnbRx(t).receive_pusch(rx.to(d), n0) for d, t in txs.items()}
    _equal("EnbRx PUSCH", out["cpu"][:2], out[dev][:2])
    snr_c, snr_g = out["cpu"][2][1], out[dev][2][1].cpu()
    if not (bool(out["cpu"][1].all()) and torch.equal(out["cpu"][0], tb)
            and float((snr_c - snr_g).abs().max()) < 1e-3):
        raise AssertionError(f"EnbRx PUSCH + SRS: {out['cpu']} {out[dev]}")
    d = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=torch.complex64)
    wave = txs["cpu"].pucch_subframe(d)
    rx = wave + 0.5 ** 0.5 * 10.0 ** -0.3 * torch.complex(
        *torch.randn(2, *wave.shape, generator=gen))
    signs = [torch.sign(EnbRx(txs[dv]).receive_pucch(
        rx.to(dv), 10.0 ** -0.6).real.cpu()) for dv in ("cpu", dev)]
    if not (torch.equal(signs[0], signs[1]) and torch.equal(signs[0],
                                                            d.real)):
        raise AssertionError(f"EnbRx PUCCH 1a: {signs}")
    print(f"small EnbRx: PUSCH + SRS TB flags and bits equal on card and CPU"
          f" (all decode), SRS SNR {snr_c.tolist()} dB; PUCCH 1a signs "
          f"{signs[0].tolist()} on both", flush=True)


def check_small_per_tti(dev) -> None:
    """Phase 27: this slice's paths at small size, card (kernels) against
    CPU (plain versions) on the same injected draws, 30 dB unless noted:
    FullChainSim on AWGN and EVA over 4 rounds, UeRx.receive with TM 2,
    EnbRx with SRS and PUCCH, UlGrantSim over 2 rounds, a TddFrameSim frame
    at 6 PRB and cold_start."""
    for case, snr in ((dict(mcs=4, channel="AWGN"), 30.0),
                      (dict(mcs=10, channel="EVA"), 30.0),
                      (dict(mcs=10, channel="EVA"), 6.0)):
        res = _small_fullsim(dev, case, snr, seed=20)
        print(f"small FullChainSim 25 PRB {case} 4 rounds at {snr} dB: errs "
              f"{res.errs.tolist()} reach {res.reach.tolist()} DCI misses "
              f"{int(res.dci_miss)} PHICH errors {int(res.phich_err)}; every "
              "round's TB, DCI and PHICH flags equal on card and CPU",
              flush=True)
        if snr > 20 and (int(res.errs.sum()) or int(res.dci_miss)
                         or int(res.phich_err)):
            raise AssertionError(f"FullChainSim at {snr} dB: {res}")
    a = _small_ue_rx(dev)
    print(f"small UeRx TM2 25 PRB at 30 dB: CFI {a['cfi_hat'].tolist()}, "
          "both DCIs, TB bits and flags, PHICH decisions equal on card and "
          "CPU", flush=True)
    _small_uplink_sched(dev)

    cfg = UlGrantConfig(n_rb=25, mcs_ul=10, rb_offset=0, n_prb=20,
                        n_harq_rounds=2, batch=4, n_turbo_iter=4,
                        decoder_window=240)
    sims = {d: UlGrantSim(cfg, device=d) for d in ("cpu", dev)}
    for snr_dl, snr_ul in ((30.0, 30.0), (30.0, 0.0), (-30.0, 30.0)):
        draws = sims["cpu"].draw(torch.Generator().manual_seed(23))
        res = {d: s.trial(*draws, 10.0 ** (-snr_dl / 10),
                          10.0 ** (-snr_ul / 10), s.wiener(snr_dl, snr_ul))
               for d, s in sims.items()}
        _equal(f"UlGrantSim DL {snr_dl} UL {snr_ul}", res["cpu"],
               res[dev])
        print(f"small UlGrantSim 25 PRB 2 rounds DL {snr_dl} UL {snr_ul} dB: "
              f"DCI errors {int(res['cpu'].dci_errs)}, errs "
              f"{res['cpu'].errs.tolist()} equal on card and CPU", flush=True)

    sims = {d: TddFrameSim(TddsimConfig(batch=4, n_turbo_iter=4,
                                        decoder_window=240), device=d)
            for d in ("cpu", dev)}
    noise = sims["cpu"].draw(torch.Generator().manual_seed(24))
    out = {d: s.run_frame(30.0, seed=3, noise=noise)
           for d, s in sims.items()}
    keys = ("dl_ok", "ul_ok", "log", "n_dl_assignments")
    if [out["cpu"][k] for k in keys] != [out[dev][k] for k in keys] or not (
            np.array_equal(out["cpu"]["dai_miss"], out[dev]["dai_miss"])
            and np.array_equal(out["cpu"]["ack_bundle"],
                               out[dev]["ack_bundle"])):
        raise AssertionError(f"small TddFrameSim: {out}")
    print(f"small TddFrameSim 6 PRB config 1 at 30 dB: DL {out[dev]['dl_ok']}"
          f"/{out[dev]['dl_tot']}, UL {out[dev]['ul_ok']}/"
          f"{out[dev]['ul_tot']}, DAI and bundled ACKs equal on card and CPU"
          f"; SRS {out['cpu']['srs']:.4f} / {out[dev]['srs']:.4f} dB",
          flush=True)

    cfg = FullsimConfig(n_rb=25, batch=8)
    for snr in (10.0, -9.0):
        got = {d: FullChainSim(cfg, device=d).cold_start(snr, batch=8,
                                                         seed=1)
               for d in ("cpu", dev)}
        if got["cpu"] != got[dev]:
            raise AssertionError(f"cold start at {snr} dB: {got}")
        print(f"small cold start 25 PRB at {snr} dB: {got[dev]} on card and "
              "CPU", flush=True)


# FullChainSim's shapes: 100 PRB at CFI 3 holds 12,600 PDSCH REs and 88
# CCEs (3,168 PDCCH REs); MCS 4 is 2 blocks of K = 3,648 a TB (N = 3,840,
# 16 windows), at the defaults' batch of 32.
FULL_PDSCH_RE, FULL_PDCCH_RE = 12600, 88 * 36
FULL_MCS4_ROWS, FULL_MCS4_N = 32 * 2, 3840
# mrc_llr's per-TTI shapes are timed over a ring of input copies that
# holds at least twice the H100's 50 MB L2 (at most RING_MAX copies), so
# that a call reads its operands from HBM as the path's fresh gathers do.
RING_BYTES, RING_MAX = 2 * 50e6, 64


def _hold_mrc(label: str, lead: tuple, A: int, Qm: int, n0_scalar: bool,
              dev, gen, timings) -> dict:
    """mrc_llr at y, H [*lead, A] (n0 a number, or per RE) against its
    plain version within MRC_RTOL/ATOL; its time by CUDA events over a
    ring of input copies (RING_BYTES), queued for phase 16's device time.
    Returns the kernels-line row."""
    n_re = int(np.prod(lead))
    n_bytes = 16 * n_re * A + 4 * n_re * Qm + (0 if n0_scalar else 4 * n_re)
    copies = int(min(RING_MAX, max(1, np.ceil(RING_BYTES / n_bytes))))

    def inputs():
        y, H = (torch.view_as_complex(torch.randn(*lead, A, 2, generator=gen,
                                                  device=dev))
                for _ in range(2))
        n0 = 0.05 if n0_scalar else \
            0.01 + torch.rand(*lead, generator=gen, device=dev)
        return y, H, n0, Qm

    ring = [inputs() for _ in range(copies)]
    got, want = mrc_llr(*ring[0]), mrc_llr_ref(*ring[0])
    torch.cuda.synchronize()
    err, ratio = _worst_ratio(got, want, MRC_RTOL, MRC_ATOL)
    turn = itertools.cycle(ring)

    def kernel():
        return mrc_llr(*next(turn))

    ms = _time_ms(kernel, 50)
    plain = _time_ms(lambda: mrc_llr_ref(*ring[0]), 5)
    bound = _mrc_bound(n_re, A, Qm, 1 if n0_scalar else n_re)
    kind = "n0 scalar" if n0_scalar else "n0 per RE"
    print(f"mrc_llr {label} A={A} Qm={Qm} {list(lead)} {kind}: max|diff| "
          f"{err:.3g}, max |diff|/(atol+rtol|ref|) {ratio:.3g} (must be "
          f"<= 1); kernel {ms:.4f} ms over a ring of {copies} input copies "
          f"({copies * n_bytes / 1e6:.1f} MB), plain {plain:.4f} ms, bound "
          f"{bound['bound_ms']:.5f} ms ({bound['bound_by']})", flush=True)
    if not ratio <= 1.0:
        raise AssertionError(f"mrc_llr {label} disagrees: {ratio}")
    row = {"shape": f"{label} {list(lead)} A={A} Qm={Qm} {kind}",
           "max_abs_err": err, "ms": ms, "plain_ms": plain,
           "ring_copies": copies, **bound}
    timings.append((f"mrc_llr {label} A={A} Qm={Qm} REs={n_re}", kernel,
                    f"mrc_llr_kernel<{A},{Qm}>", row))
    return row


def _hold_v2(label: str, B: int, N: int, W: int, U: int, dev, gen,
             timings, pad_from: int | None = None) -> dict:
    """The v2 kernel at lin, lp [B, N] (3 N(0, 1); 1e4 from pad_from on,
    the forced pad after the trellis' end, where the block length is
    known) against its plain version, bit for bit; its time by CUDA
    events, queued for phase 16's device time. Returns the row."""
    lin = 3.0 * torch.randn(B, N, generator=gen, device=dev)
    lp = 3.0 * torch.randn(B, N, generator=gen, device=dev)
    if pad_from is not None:
        lin[:, pad_from:] = 1e4
        lp[:, pad_from:] = 1e4
    got = half_iteration(lin, lp, W, U)
    want = half_iteration_ref(lin, lp, W, U)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    kernel = functools.partial(half_iteration, lin, lp, W, U)
    ms = _time_ms(kernel, 20)
    plain = _time_ms(lambda: half_iteration_ref(lin, lp, W, U), 3)
    bound = _bound(3 * 4 * B * N, TURBO_OPS_PER_POS * B * N)
    print(f"turbo_half_iter {label} [{B}, {N}] W={W} U={U}: max|diff| "
          f"{err:.3g} (tol {TURBO_ATOL}); kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {bound['bound_ms']:.5f} ms "
          f"({bound['bound_by']})", flush=True)
    if not err <= TURBO_ATOL:
        raise AssertionError(f"turbo kernel at {label} [{B}, {N}]: {err}")
    row = {"shape": f"{label} {B:,} x {N:,}", "max_abs_err": err, "ms": ms,
           "plain_ms": plain, **bound}
    timings.append((f"turbo_half_iter {label} {B} x {N}", kernel,
                    "turbo_half_iter_kernel<", row))
    return row


def check_kernels_per_tti(dev, gen, timings) -> list:
    """Phase 28: mrc_llr at A = 1 with n0 a number, as UeRx passes it, at
    the PCFICH [128, 16], FullChainSim's PDCCH [128, 3,168] and MCS 4
    PDSCH [32, 12,600] (Qm 2) and its MCS 26 PDSCH [128, 12,600] (Qm 6)
    within rtol = atol = 3e-4 of its plain version; v2 at FullChainSim's
    MCS 4 shape, 64 x 3,840, bit-exact. Returns [(kernel, the launch key
    of count_launch, row)]."""
    held = []
    for label, lead, Qm in (("PCFICH", (BATCH, 16), 2),
                            ("fullsim PDCCH", (BATCH, FULL_PDCCH_RE), 2),
                            ("fullsim MCS 4 PDSCH", (32, FULL_PDSCH_RE), 2),
                            ("fullsim MCS 26 PDSCH", (BATCH, FULL_PDSCH_RE),
                             6)):
        row = _hold_mrc(label, lead, 1, Qm, True, dev, gen, timings)
        held.append(("mrc_llr", (lead + (1,), Qm, True), row))
    row = _hold_v2("fullsim MCS 4", FULL_MCS4_ROWS, FULL_MCS4_N, TURBO_W,
                   TURBO_U, dev, gen, timings, pad_from=3651)
    held.append(("turbo_half_iter",
                 (FULL_MCS4_ROWS, FULL_MCS4_N, TURBO_W, TURBO_U), row))
    return held


def _sum_shapes(*shape_counts) -> dict:
    out = {}
    for counts in shape_counts:
        for k, v in counts.items():
            out[k] = out.get(k, 0) + v
    return out


def _per_step(shapes: dict, steps: int, what: str) -> dict:
    """{(kernel, launch key): (launches a step, what a step is)}."""
    return {k: (v / steps, what) for k, v in shapes.items()}


def check_kernels_launched(dev, gen, timings, launched: dict, held: list,
                           where: dict) -> list:
    """Phase 33: every (kernel, shape) that the full-width paths of phases
    29-31 launched and phase 28 did not hold, against its plain version on
    random inputs of that shape: mrc_llr within rtol = atol = 3e-4, v2 bit
    for bit; each labelled with where[(kernel, shape)], the run it was
    counted a step of. Only those two kernels may launch there. Returns
    [(kernel, launch key, row)] as check_kernels_per_tti does."""
    done = {(name, key) for name, key, _ in held}
    out = []
    for name, key in sorted(launched, key=str):
        if (name, key) in done:
            continue
        label = where.get((name, key), "phases 29-31")
        if name == "mrc_llr":
            shape, Qm, n0_scalar = key
            row = _hold_mrc(label, shape[:-1], shape[-1], Qm, n0_scalar, dev,
                            gen, timings)
        elif name == "turbo_half_iter":
            row = _hold_v2(label, *key, dev, gen, timings)
        else:
            raise AssertionError(f"{name} {key} launched on the per-TTI "
                                 "paths: only v2 and mrc_llr may be")
        out.append((name, key, row))
    return out


# The flagship load through the full chain: what `fullsim_main -B 100 -m
# 26 -g EVA -b 128` runs (4 HARQ rounds, 8 iterations, CFI 3).
FULL_LOAD = dict(n_rb=100, mcs=26, channel="EVA", n_harq_rounds=4,
                 n_turbo_iter=8, batch=BATCH)
FULL_HIGH_SNR, FULL_MID_SNR = 34.0, 22.0


def fullsim_full_width(dev) -> tuple:
    """Phase 29: FullChainSim at the flagship load. At FULL_HIGH_SNR every
    DCI is found and every TB decodes within the 4 rounds; near
    FULL_MID_SNR (moved in 2 dB steps while round-0 BLER is outside [0.02,
    0.98]) round 1 fails fewer than round 0 and at most 1 % of the DCIs are
    missed; mrc_llr launches twice a round, v2 launches; TB trials/s on the
    host clock. Returns the launches by (kernel, shape) over both SNRs,
    those a step at the mid SNR, and (sim, mid SNR)."""
    sim = FullChainSim(FullsimConfig(**FULL_LOAD), device=dev)
    R = sim.cfg.n_harq_rounds
    sim.run_snr(FULL_HIGH_SNR, BATCH, seed=99)      # settle the allocator
    torch.cuda.synchronize()
    reset_launch_counts()
    errs, reach = sim.run_snr(FULL_HIGH_SNR, 2 * BATCH, seed=1)
    shapes_hi = launch_shapes()
    print(f"fullsim 100 PRB MCS 26 EVA 4 rounds at {FULL_HIGH_SNR} dB: errs "
          f"{errs.tolist()} reached {reach.tolist()}, DCI misses "
          f"{sim.dci_miss}, PHICH errors {sim.phich_err}", flush=True)
    if errs[-1] or sim.dci_miss:
        raise AssertionError(f"fullsim at {FULL_HIGH_SNR} dB: {errs}, "
                             f"{sim.dci_miss} DCI misses")
    snr, tried, steps = FULL_MID_SNR, [], 8
    while True:
        reset_launch_counts()
        t0 = time.perf_counter()
        errs, reach = sim.run_snr(snr, steps * BATCH, seed=1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts, shapes = launch_counts(), launch_shapes()
        bler = errs / np.maximum(reach, 1)
        tried.append(snr)
        if 0.02 <= bler[0] <= 0.98 or len(tried) == 5:
            break
        snr += 2.0 if bler[0] > 0.98 else -2.0
    print(f"fullsim 100 PRB MCS 26 EVA 4 rounds at {snr} dB (tried {tried}): "
          f"per-round BLER {[round(float(x), 4) for x in bler]} (errs "
          f"{errs.tolist()}, reached {reach.tolist()}), DCI misses "
          f"{sim.dci_miss}, PHICH errors {sim.phich_err}; "
          f"{dt / steps * 1e3:.1f} ms a step, {steps * BATCH / dt:.1f} TB "
          f"trials/s ({steps} steps of {BATCH} x {R} rounds, {dt:.3f} s)",
          flush=True)
    print(f"launches over the fullsim runs at {snr} dB: {counts}", flush=True)
    if not 0.02 <= bler[0] <= 0.98:
        raise AssertionError(f"fullsim round-0 BLER {bler[0]} outside "
                             "[0.02, 0.98]")
    if not errs[1] < errs[0]:
        raise AssertionError(f"fullsim: no HARQ gain {errs}")
    if sim.dci_miss > 0.01 * reach[0]:
        raise AssertionError(f"fullsim: {sim.dci_miss} DCI misses")
    if counts["mrc_llr"] != 2 * R * steps or counts["turbo_half_iter"] == 0 \
            or counts["demap_llr"] or counts["turbo_half_iter_v1"]:
        raise AssertionError(f"fullsim launches {counts}: mrc_llr must "
                             f"launch 2 x {R} rounds x {steps} steps")
    return (_sum_shapes(shapes_hi, shapes),
            _per_step(shapes, steps, f"fullsim flagship load at {snr} dB"),
            (sim, snr))


def fullsim_defaults_and_entry_points(dev) -> dict:
    """Phase 30: FullsimConfig() (100 PRB, MCS 4, AWGN, 4 rounds, batch 32)
    at 6 dB: every TB in round 0, no DCI miss, no PHICH error
    (tests/test_fullsim.py:66-73 at full width); cold start at 100 PRB;
    fullsim_main writing the reference's CSV schema (its rate column is
    TBS over the CFI-1 G, 7,224 / 30,000, as the reference's);
    generate_frame at 100 PRB equal to its CPU run. Returns the launches
    by (kernel, shape) and those a step of the defaults' run."""
    reset_launch_counts()
    sim = FullChainSim(FullsimConfig(), device=dev)
    errs, reach = sim.run_snr(6.0, 4 * sim.cfg.batch, seed=2)
    per_step = _per_step(launch_shapes(), 4, "fullsim defaults at 6 dB")
    print(f"fullsim defaults (100 PRB MCS 4 AWGN 4 rounds batch 32) at 6 dB: "
          f"errs {errs.tolist()} reached {reach.tolist()}, DCI misses "
          f"{sim.dci_miss}, PHICH errors {sim.phich_err}", flush=True)
    if errs[0] or sim.dci_miss or sim.phich_err:
        raise AssertionError(f"fullsim defaults at 6 dB: {errs}")
    r = sim.cold_start(10.0, batch=16)
    print(f"cold start 100 PRB at 10 dB, 16 captures: {r}", flush=True)
    if r["sync_rate"] < 0.9 or r["mib_rate"] < 0.9 or r["mib"]["n_rb"] != 100:
        raise AssertionError(f"cold start at 100 PRB: {r}")
    os.makedirs("build", exist_ok=True)
    path = "build/fullsim_100prb_mcs4.csv"
    rows = fullsim_main(["-B", "100", "-m", "4", "-s", "-2", "-S", "0",
                         "-i", "2", "-n", "64", "-b", "32", "-o", path])
    with open(path) as f:
        lines = f.read().splitlines()
    cols = [line.split(";") for line in lines]
    if len(lines) != len(rows) or any(len(c) != 4 + 2 * 4 + 1 for c in cols) \
            or cols[0][:4] != ["-2", "4", "7224", "0.240800"]:
        raise AssertionError(f"fullsim_main CSV: {lines}")
    print(f"fullsim_main on the card wrote {path}: {lines}", flush=True)
    cell = CellConfig(n_rb=100, n_id_cell=7)
    frames = [generate_frame(cell, sfn=1, fill_pdsch=True, seed=4, device=d)
              for d in (dev, "cpu")]
    diff = np.abs(frames[0] - frames[1]).max() / np.abs(frames[1]).max()
    print(f"generate_frame 100 PRB: {frames[0].shape[0]} samples, card "
          f"against CPU max |diff| {diff:.3g} of scale (must be <= 1e-5)",
          flush=True)
    if not diff <= 1e-5:
        raise AssertionError(f"generate_frame card vs CPU: {diff}")
    return launch_shapes(), per_step


# The closed loops at full width: the format-0 grant for 96 PRB at MCS 20
# (16QAM), and TDD configuration 1 at 100 PRB.
GRANT_FULL = dict(n_rb=100, rb_offset=2, n_prb=96, mcs_ul=20,
                  n_harq_rounds=4, batch=BATCH)


def closed_loops_full_width(dev) -> tuple:
    """Phase 31: UlGrantSim at GRANT_FULL with the DL at 20 dB and the UL at
    30 dB (no DCI error, every TB decodes) and with the DL at -30 dB (every
    trial a DCI error, no TB), each point twice in turn, with its step time
    on the host clock; TddFrameSim configuration 1, 100 PRB, CFI 2, batch
    32, 12 dB (every DL and UL TB decodes, DSUUDDSUUD, no DAI miss).
    Returns the launches by (kernel, shape), and those a step of
    UlGrantSim at DL 20 / UL 30 dB and a frame of TddFrameSim."""
    sim = UlGrantSim(UlGrantConfig(**GRANT_FULL), device=dev)
    sim.run_snr(20.0, 30.0, BATCH, seed=99)          # settle the allocator
    reset_launch_counts()
    per_step = {}
    for snr_dl, snr_ul in ((20.0, 30.0), (-30.0, 30.0)) * 2:
        t0 = time.perf_counter()
        d, errs, reach = sim.run_snr(snr_dl, snr_ul, 2 * BATCH, seed=1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not per_step:
            per_step = _per_step(launch_shapes(), 2,
                                 "UlGrantSim DL 20 / UL 30 dB")
        print(f"UlGrantSim 100 PRB, 96 PRB granted at MCS 20, 4 rounds, DL "
              f"{snr_dl} UL {snr_ul} dB: DCI errors {d}/{reach[0]}, errs "
              f"{errs.tolist()} reached {reach.tolist()}; {dt / 2 * 1e3:.1f} "
              f"ms a step of {BATCH}", flush=True)
        if snr_dl > 0 and (d or errs[-1]):
            raise AssertionError(f"UlGrantSim at {snr_dl}/{snr_ul}: {d} "
                                 f"{errs}")
        if snr_dl < 0 and (d != reach[0] or errs[-1] != reach[0]):
            raise AssertionError(f"UlGrantSim DL {snr_dl}: {d} {errs}")
    shapes = launch_shapes()
    counts = launch_counts()
    tdd = TddFrameSim(TddsimConfig(tdd_config=1, n_rb=100, n_pdcch=2,
                                   batch=32), device=dev)
    tdd.run_frame(12.0, seed=9)                     # build the chains
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = tdd.run_frame(12.0, seed=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    pattern = "".join(d for _, d, _ in out["log"])
    print(f"TddFrameSim config 1 100 PRB CFI 2 batch 32 at 12 dB: "
          f"{pattern}, DL {out['dl_ok']}/{out['dl_tot']}, UL {out['ul_ok']}/"
          f"{out['ul_tot']}, DAI misses {int(out['dai_miss'].sum())}, SRS "
          f"{out['srs']:.2f} dB; {dt * 1e3:.1f} ms a frame", flush=True)
    if pattern != "DSUUDDSUUD" or out["dl_ok"] != out["dl_tot"] \
            or out["ul_ok"] != out["ul_tot"] or out["dai_miss"].any():
        raise AssertionError(f"TddFrameSim at 100 PRB: {out}")
    tdd_shapes = launch_shapes()
    counts = {k: v + launch_counts()[k] for k, v in counts.items()}
    if counts["turbo_half_iter"] == 0 or counts["mrc_llr"] == 0:
        raise AssertionError(f"closed loops: launches {counts}")
    frame = _per_step(tdd_shapes, 1, "TddFrameSim frame at 12 dB")
    return _sum_shapes(shapes, tdd_shapes), {**frame, **per_step}


def per_tti_anchors(dev) -> dict:
    """Phase 32: the reference's anchors of this slice on the card, with its
    configurations, trial counts and assertions (tests/test_fullsim.py:
    76-83, tests/test_sched_ul.py:123-134, tests/test_tddsim.py:31-39,
    50-66 and 69-92)."""
    reset_launch_counts()
    sim = FullChainSim(FullsimConfig(n_rb=25, mcs=10, channel="EVA",
                                     n_harq_rounds=3, batch=32,
                                     n_turbo_iter=6), device=dev)
    errs, reach = sim.run_snr(6.0, 32)
    print(f"test_fullsim EVA HARQ gain: errs {errs.tolist()} reached "
          f"{reach.tolist()} (reach[0] = 32, errs[-1] <= errs[0])",
          flush=True)
    if not (reach[0] == 32 and errs[-1] <= errs[0]):
        raise AssertionError(f"fullsim HARQ gain anchor: {errs} {reach}")
    g = UlGrantSim(UlGrantConfig(n_rb=25, mcs_ul=10, rb_offset=0, n_prb=20,
                                 n_harq_rounds=3, batch=16, n_turbo_iter=5),
                   device=dev)
    d, errs, reach = g.run_snr(20.0, -2.5, 16)
    print(f"test_sched_ul HARQ at UL -2.5 dB: DCI errors {d}, errs "
          f"{errs.tolist()} (0; > 0; fewer in the last round)", flush=True)
    if not (d == 0 and errs[0] > 0 and errs[-1] < errs[0]):
        raise AssertionError(f"UL grant HARQ anchor: {d} {errs}")
    out = TddFrameSim(TddsimConfig(tdd_config=2, batch=2),
                      device=dev).run_frame(12.0)
    dirs = "".join(d for _, d, _ in out["log"])
    print(f"test_tddsim config 2: {dirs}, DL {out['dl_tot']}, UL "
          f"{out['ul_tot']}", flush=True)
    if dirs != "DSUDDDSUDD" or out["dl_tot"] != 12 or out["ul_tot"] != 4:
        raise AssertionError(f"TDD config 2 anchor: {out}")
    for cfg, n_dl, n_ul in ((dict(tdd_config=1, n_rb=25, n_pdcch=2,
                                  batch=2), 8, 8),
                            (dict(tdd_config=2, n_rb=50, n_pdcch=2,
                                  batch=1), 6, 2)):
        out = TddFrameSim(TddsimConfig(**cfg), device=dev).run_frame(12.0)
        print(f"test_tddsim {cfg}: DL {out['dl_ok']}/{out['dl_tot']}, UL "
              f"{out['ul_ok']}/{out['ul_tot']}", flush=True)
        if not (out["dl_ok"] == out["dl_tot"] == n_dl
                and out["ul_ok"] == out["ul_tot"] == n_ul):
            raise AssertionError(f"TDD frame anchor {cfg}: {out}")
    snr = 0.2
    tdd = TddFrameSim(TddsimConfig(tdd_config=1, n_rb=25, n_pdcch=1,
                                   mcs_dl=4, batch=16), device=dev)
    outs = [tdd.run_frame(snr, seed=seed) for seed in range(4)]
    tdd_bler = 1 - sum(o["dl_ok"] for o in outs) / sum(o["dl_tot"]
                                                       for o in outs)
    fdd = DlsimFading(DlsimFadingConfig(mcs=4, n_rb=25, channel="AWGN",
                                        n_harq_rounds=1, batch=64),
                      device=dev)
    e, r = fdd.run_snr(snr, 256)
    print(f"test_tddsim TDD on the FDD waterfall at {snr} dB: TDD BLER "
          f"{tdd_bler:.4f}, FDD {e[0] / r[0]:.4f} (within 0.15)", flush=True)
    if not abs(tdd_bler - e[0] / r[0]) < 0.15:
        raise AssertionError(f"TDD vs FDD anchor: {tdd_bler} {e} {r}")
    return launch_shapes()


# ------------------------------------------------------------ oaisim --
# Phase 34's configurations at 6 PRB: the abstraction mode (EESM and
# MIESM, 4 HARQ rounds, PF, TDD, UL traffic, the handover walk of
# tests/test_handover.py) and the full-PHY mode with 2 eNBs and 4 UEs on
# AWGN and EPA over 2 frames with 4 HARQ rounds, decoder window 240 on
# both sides. (label, config, frames; None: the handover walk)
_SMALL_OAISIM = [
    ("EESM, PF, 4 rounds", dict(n_enb=2, n_ue=8, mcs=10, tx_power_db=24.0,
                                mac="pf", n_harq_rounds=4, seed=11), 10),
    ("MIESM, TDD, UL, 4 rounds", dict(n_enb=2, n_ue=6, mcs=10, esm="miesm",
                                      tx_power_db=30.0, duplex="tdd",
                                      ul_traffic=True, n_harq_rounds=4,
                                      seed=1), 10),
    ("handover", dict(n_enb=2, n_ue=1, mobility="static", handover=True,
                      a3_ttt_frames=1, seed=3), None),
    ("full PHY AWGN", dict(n_enb=2, n_ue=4, mcs=20, tx_power_db=45.0,
                           mode="phy", channel="AWGN", n_harq_rounds=4,
                           n_turbo_iter=4, seed=2), 2),
    ("full PHY EPA", dict(n_enb=2, n_ue=4, mcs=16, tx_power_db=45.0,
                          mode="phy", channel="EPA", n_harq_rounds=4,
                          n_turbo_iter=4, seed=2), 2),
]
# A coin flip decides alike on the card and the CPU when the uniform lies
# further than this from the BLER (float32 rounding is far below it).
FLIP_MARGIN = 1e-5


def _oaisim_walk(sim) -> None:
    """tests/test_handover.py's drive: the one UE placed in cell 0, then
    moved toward cell 1 a frame a step."""
    sim.ue_xy[0] = [50.0, 0.0]
    sim._update_links()
    sim.serving_rrc[:] = np.argmax(sim.p_rx, axis=1)
    sim._update_links()
    for x in (50, 150, 250, 330, 420, 480, 480, 480):
        sim.ue_xy[0] = [float(x), 0.0]
        sim._update_links()
        yield x


def _oaisim_run(sim, frames, draws) -> tuple:
    """Run sim (frames, or the handover walk) on `draws` and close its
    pcap; returns (the per-TTI (abs TTI, sched, err) flags, summary())."""
    flags = []
    trace = sim._trace_tti

    def hook(tti, sched, err, tb=None):
        flags.append((sim._frame * 10 + tti, sched.copy(), err.copy()))
        return trace(tti, sched, err, tb)
    sim._trace_tti = hook
    if frames is None:
        for _ in _oaisim_walk(sim):
            out = sim.run_frames(1, draws=draws)
    else:
        out = sim.run_frames(frames, draws=draws)
    sim.pcap.close()
    return flags, out


def check_small_oaisim(dev) -> None:
    """Phase 34: each _SMALL_OAISIM configuration on the CPU and on the
    card, on the same draws (the CPU sim's, kept by TTI, and its initial
    taps): every per-TTI error flag, every stats array, summary()
    (handover events included) and the pcap bytes must be equal. In the
    abstraction mode every scheduled UE's uniform must lie more than
    FLIP_MARGIN from its BLER."""
    os.makedirs("build", exist_ok=True)
    for label, case, frames in _SMALL_OAISIM:
        if case.get("mode") == "phy":
            case = dict(case, decoder_window=240)
        cpu, gpu = (Oaisim(OaisimConfig(n_rb=6, **case),
                           pcap_path=f"build/oaisim_{d}.pcap", device=d)
                    for d in ("cpu", dev))
        gpu.taps = cpu.taps.to(dev)
        kept, blers = {}, []
        lookup = cpu.table.lookup

        def record(eff):
            blers.append(lookup(eff))
            return blers[-1]

        def draw(t):
            kept[t] = cpu.draw()
            return kept[t]
        cpu.table.lookup = record
        fa, oa = _oaisim_run(cpu, frames, draw)
        fb, ob = _oaisim_run(gpu, frames, kept.__getitem__)
        pa, pb = (open(f"build/oaisim_{d}.pcap", "rb").read()
                  for d in ("cpu", dev))
        gaps = [float((kept[t].uniforms - b).abs()[torch.as_tensor(s)].min())
                for (t, s, _), b in zip(fa, blers) if s.any()]
        if gaps and not min(gaps) > FLIP_MARGIN:
            raise AssertionError(f"small oaisim {label}: a coin flip within "
                                 f"{FLIP_MARGIN} of its BLER")
        if [(t, s.tolist(), e.tolist()) for t, s, e in fa] != \
                [(t, s.tolist(), e.tolist()) for t, s, e in fb]:
            raise AssertionError(f"small oaisim {label}: per-TTI flags")
        for k in cpu.stats:
            if not np.array_equal(cpu.stats[k], gpu.stats[k]):
                raise AssertionError(f"small oaisim {label}: stats {k}")
        for k in oa:
            if not np.array_equal(oa[k], ob[k]):
                raise AssertionError(f"small oaisim {label}: summary {k}")
        if pa != pb or not pa:
            raise AssertionError(f"small oaisim {label}: pcap bytes")
        hos = (f", {len(oa['ho_events'])} handovers" if "ho_events" in oa
               else "")
        print(f"small oaisim {label}: card = CPU over {len(fa)} downlink "
              f"TTIs ({sum(int(e.sum()) for _, _, e in fa)} TB errors, "
              f"{oa['retx_total']} retransmissions, mean BLER "
              f"{oa['mean_bler']:.4f}{hos}; pcap {len(pa)} bytes; least "
              f"coin-flip margin {min(gaps) if gaps else None})", flush=True)


# Full PHY at full width: 128 UEs x 5 blocks of K = 6,144 (MCS 16, 100
# PRB: TBS 30,576) decode as 640 rows of N = 6,240 (26 windows of 240)
# for each eNB; the trellis ends at K + 3 = 6,147.
OAISIM_ROWS, OAISIM_N, OAISIM_KT = 128 * 5, 6240, 6147


def check_turbo_oaisim(dev, gen, timings) -> dict:
    """Phase 35: v2 at the full-PHY oaisim shape, bit for bit."""
    return _hold_v2("oaisim full PHY", OAISIM_ROWS, OAISIM_N, TURBO_W,
                    TURBO_U, dev, gen, timings, pad_from=OAISIM_KT)


def oaisim_full_phy(dev) -> tuple:
    """Phase 36: the full-PHY Oaisim at full width (phase_split's
    OAISIM_FULL: 3 eNBs 500 m apart, 128 static UEs, 100 PRB, MCS 16, EPA,
    4 HARQ rounds, 6 iterations, full buffer, RR, TX power 60 dB) over 4
    frames. Every eNB schedules every TTI (tb_sent + retx = 120), no UE
    whose geometry SINR is at least 20 dB loses a TB, v2 launches on every
    TTI at 640 x 6,240 and no other kernel launches. Then 1 eNB at 70 dB
    loses no TB and retransmits none. Returns (launches by (kernel,
    shape), v2 launches a TTI, the 3-eNB sim)."""
    sim = Oaisim(OaisimConfig(**OAISIM_FULL), device=dev)
    per_tti = []
    tti_phy = sim._tti_phy

    def counted(*args):
        n = launch_counts()["turbo_half_iter"]
        err = tti_phy(*args)
        per_tti.append(launch_counts()["turbo_half_iter"] - n)
        return err
    sim._tti_phy = counted
    frame_s = []
    torch.cuda.synchronize()
    reset_launch_counts()
    for _ in range(4):
        t0 = time.perf_counter()
        out = sim.run_frames(1)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    counts, shapes = launch_counts(), launch_shapes()
    st = sim.stats
    U = sim.cfg.n_ue
    sig = sim.p_rx[np.arange(U), sim.serving]
    sinr_db = 10 * np.log10(sig / (sim.p_rx.sum(1) - sig + 1.0))
    strong = sinr_db >= 20.0
    lost_strong = int(st["tb_err"][strong].sum())
    print(f"oaisim full PHY 3 eNBs x 128 UEs 100 PRB MCS 16 EPA 4 rounds, 4 "
          f"frames: mean BLER {out['mean_bler']:.4f}, TBs sent "
          f"{int(st['tb_sent'].sum())}, lost {int(st['tb_err'].sum())}, "
          f"retransmissions {out['retx_total']}, sum throughput "
          f"{out['sum_throughput_mbps']:.2f} Mbit/s; {int(strong.sum())} UEs "
          f"at geometry SINR >= 20 dB lost {lost_strong} TBs; "
          f"{np.mean(frame_s[1:]) / 10 * 1e3:.1f} ms a TTI over frames 2-4 "
          f"({frame_s[0] / 10 * 1e3:.1f} ms in frame 1); v2 launches a TTI "
          f"{min(per_tti)}-{max(per_tti)} (mean {np.mean(per_tti):.1f})",
          flush=True)
    print(f"launches over the 4 frames: {counts}; by shape {shapes}",
          flush=True)
    if int(st["tb_sent"].sum() + st["retx"].sum()) != 3 * 40:
        raise AssertionError(f"oaisim full PHY: {st['tb_sent'].sum()} + "
                             f"{st['retx'].sum()} grants, not 120")
    if lost_strong:
        raise AssertionError(f"oaisim full PHY: {lost_strong} TBs lost at "
                             "geometry SINR >= 20 dB")
    if len(per_tti) != 40 or min(per_tti) == 0:
        raise AssertionError(f"oaisim full PHY: v2 launches a TTI {per_tti}")
    if set(shapes) != {("turbo_half_iter", (OAISIM_ROWS, OAISIM_N, TURBO_W,
                                            TURBO_U))}:
        raise AssertionError(f"oaisim full PHY launched {shapes}")
    one = Oaisim(OaisimConfig(**dict(OAISIM_FULL, n_enb=1,
                                     tx_power_db=70.0)), device=dev)
    reset_launch_counts()
    out1 = one.run_frames(4)
    torch.cuda.synchronize()
    shapes = _sum_shapes(shapes, launch_shapes())
    st1 = one.stats
    print(f"oaisim full PHY 1 eNB x 128 UEs at 70 dB, 4 frames: TBs sent "
          f"{int(st1['tb_sent'].sum())}, lost {int(st1['tb_err'].sum())}, "
          f"retransmissions {out1['retx_total']}, sum throughput "
          f"{out1['sum_throughput_mbps']:.2f} Mbit/s; v2 launches "
          f"{launch_counts()['turbo_half_iter']}", flush=True)
    if st1["tb_err"].sum() or out1["retx_total"] or \
            st1["tb_sent"].sum() != 40:
        raise AssertionError(f"oaisim 1 eNB at 70 dB: {out1}")
    return shapes, float(np.mean(per_tti)), sim


# The abstraction mode at full width, at phase 36's TX power.
OAISIM_ABS_FULL = dict(n_enb=7, n_ue=1024, n_rb=100, mcs=16, channel="EPA",
                       n_harq_rounds=4, ul_traffic=True, tx_power_db=60.0)


def oaisim_abstraction_full(dev) -> list:
    """Phase 37: the abstraction Oaisim at full width (7 eNBs, 1,024 UEs,
    100 PRB, MCS 16, EPA, 4 HARQ rounds, UL traffic, TX power 60 dB; the
    defaults' random walk at 1 m/s, full buffer, RR) over 20 frames, with
    EESM and with MIESM: every eNB schedules every TTI (tb_sent + retx =
    1,400) and no kernel launches; TTIs/s on the host clock. Returns
    [(label, sim)] for phase 16."""
    sims = []
    for esm in ("eesm", "miesm"):
        sim = Oaisim(OaisimConfig(**OAISIM_ABS_FULL, esm=esm), device=dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = sim.run_frames(20)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        st = sim.stats
        print(f"oaisim abstraction {esm.upper()} 7 eNBs x 1,024 UEs 100 PRB "
              f"MCS 16 EPA 4 rounds UL on, 20 frames: mean BLER "
              f"{out['mean_bler']:.4f}, retransmissions {out['retx_total']}"
              f", DL {out['sum_throughput_mbps']:.2f} and UL "
              f"{out['ul_throughput_mbps']:.2f} Mbit/s; {200 / dt:.1f} TTIs/s"
              f" ({dt:.2f} s)", flush=True)
        if int(st["tb_sent"].sum() + st["retx"].sum()) != 7 * 200:
            raise AssertionError(f"oaisim {esm}: {st['tb_sent'].sum()} + "
                                 f"{st['retx'].sum()} grants, not 1,400")
        _no_kernel(f"oaisim abstraction {esm}")
        sims.append((f"oaisim abstraction {esm.upper()} full width", sim))
    return sims


def oaisim_anchors(dev) -> None:
    """Phase 38: tests/test_observability.py::test_calibrated_table_matches
    _full_phy on the card (the calibrated table's knee +- 0.5 dB against
    DlsimAwgn at MCS 0, 4 and 10); the full-stack command line with 16 UEs
    over 2 eNBs; the 33.401 EEA2/EIA2 vectors through the port's AES; and
    whether `cryptography` is importable here (the port never imports
    it)."""
    for mcs in (0, 4, 10):
        table = calibrated_bler_table(mcs, n_frames=256, n_pts=7, batch=128,
                                      device=dev)
        sim = DlsimAwgn(DlsimConfig(mcs=mcs, n_rb=25, batch=128), dev)
        knee = float(np.interp(np.log(0.5), table.log_bler[::-1],
                               table.snr_db[::-1]))
        for probe in (knee - 0.5, knee + 0.5):
            errs, trials = sim.run_snr(probe, 256)
            bler = errs / trials
            pred = float(np.exp(np.interp(probe, table.snr_db,
                                          table.log_bler)))
            print(f"calibrated table MCS {mcs}: knee {knee:.2f} dB, at "
                  f"{probe:.2f} dB BLER {bler:.4f} against the table's "
                  f"{pred:.4f}", flush=True)
            if not ((bler > 0.5) == (pred > 0.5) or abs(bler - pred) < 0.25):
                raise AssertionError(f"calibrated table MCS {mcs} at {probe}"
                                     f": {bler} vs {pred}")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "openair4g_tpu_torch.sim.oaisim_fullstack", "-u",
                        "16", "-e", "2"], cwd=root, capture_output=True,
                       text=True, timeout=300)
    if r.returncode:
        raise AssertionError(f"oaisim_fullstack: {r.stderr[-2000:]}")
    res = json.loads(r.stdout)
    print(f"oaisim_fullstack -u 16 -e 2: {res['mme_registered']} registered,"
          f" all echoed {res['all_echoed']}, {res['ttis']} TTIs, stats "
          f"{res['stats']} ({time.perf_counter() - t0:.1f} s)", flush=True)
    if not (res["all_registered"] and res["all_echoed"]
            and res["mme_registered"] == 16):
        raise AssertionError(f"oaisim_fullstack: {res}")
    for d, count, bearer, key, msg, bl, want in _EEA2_33401:
        if crypto.eea2(bytes.fromhex(key), count, bearer, d,
                       bytes.fromhex(msg), bl) != bytes.fromhex(want):
            raise AssertionError(f"EEA2 33.401 vector COUNT {count:#x}")
    for d, count, bearer, key, msg, bl, want in _EIA2_33401:
        if crypto.eia2(bytes.fromhex(key), count, bearer, d,
                       bytes.fromhex(msg), bl) != bytes.fromhex(want):
            raise AssertionError(f"EIA2 33.401 vector COUNT {count:#x}")
    found = importlib.util.find_spec("cryptography") is not None
    print(f"33.401 EEA2 ({len(_EEA2_33401)}) and EIA2 ({len(_EIA2_33401)}) "
          f"vectors pass through the port's AES; `cryptography` is "
          f"{'' if found else 'not '}importable here, and the port does not "
          "import it", flush=True)


# TS 33.401 Annex C.1 / C.2 (as tests/test_crypto_33401.py has them):
# (direction, count, bearer, key, message, bit length, expected)
_EEA2_33401 = [
    (1, 0x398A59B4, 0x15, "d3c5d592327fb11c4035c6680af8c6d1",
     "981ba6824c1bfb1ab485472029b71d808ce33e2cc3c0b5fc1f3de8a6dc66b1f0",
     253,
     "e9fed8a63d155304d71df20bf3e82214b20ed7dad2f233dc3c22d7bdeeed8e78"),
    (0, 0x544D49CD, 0x04, "0a8b6bd8d9b08b08d64e32d1817777fb",
     "fd40a41d370a1f65745095687d47ba1d36d2349e23f644392c8ea9c49d40c132"
     "71aff264d0f24800", 310,
     "75750d37b4bba2a4dedb34235bd68c6645acdaaca48138a3b0c471e2a7041a57"
     "6423d2927287f000"),
]
_EIA2_33401 = [
    (1, 0x398A59B4, 0x1A, "d3c5d592327fb11c4035c6680af8c6d1",
     "484583d5afe082ae", 64, "b93787e6"),
    (1, 0x36AF6144, 0x0F, "83fd23a244a74cf358da3019f1722635",
     "35c68716633c66fb750c266865d53c11ea05b1e9fa49c8398d48e1efa5909d39"
     "47902837f5ae96d5a05bc8d61ca8dbef1b13a4b4abfe4fb1006045b674bb5472"
     "9304c382be53a5af05556176f6eaa2ef1d05e4b083181ee674cda5a485f74d7a",
     768, "e657e182"),
]


# ------------------------------------------ capstones, observability, runtime --

# The reference test's configuration (tests/test_capstone.py) and the
# reference's other ladders; at 100 PRB the JAX package on the CPU gives 53
# TTIs and these PHY runs for the first.
CAPSTONE_LADDER = dict(snr_db=12.0, seed=0)
CAPSTONE_BIG_NAS = dict(snr_db=12.0, seed=3, big_nas_bytes=450,
                        max_ttis=600)
CAPSTONE_MT = dict(mt_attach=True, paging_cycle_idx=0, max_ttis=800,
                   snr_db=12.0)
CAPSTONE_JAX_100 = dict(ttis=53, phy_runs={"dl": 16, "ul": 6, "prach": 1})


def _capstone_timers(sim) -> dict:
    """Wrap the PHY entry points of a FullStackSim with host timers that
    stop after a synchronize: the downlink transmit (the clean wave, the
    UE's noise, the OFDM demodulation) and blind receive, each uplink
    subframe and each PRACH occasion that sent a preamble. Returns the
    lists of ms they fill."""
    ms = {"dl_tx": [], "dl_rx": [], "ul": [], "prach": []}

    def wrap(obj, name, key, keep=lambda: True):
        fn = getattr(obj, name)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            if keep():
                ms[key].append((time.perf_counter() - t0) * 1e3)
            return out
        setattr(obj, name, timed)

    wrap(sim.dl, "transmit", "dl_tx")
    wrap(sim.dl, "receive", "dl_rx")
    wrap(sim.ul, "run_multi", "ul")
    sent = [0]

    def preamble_sent():
        n = sim.phy_runs["prach"]
        new, sent[0] = n > sent[0], n
        return new
    wrap(sim, "_prach_tti", "prach", preamble_sent)
    return ms


def _ms_line(ms: list) -> str:
    if not ms:
        return "none"
    return (f"{np.mean(ms):.2f} ms mean, {np.median(ms):.2f} median, "
            f"{min(ms):.2f}-{max(ms):.2f} over {len(ms)} "
            f"[{', '.join(f'{t:.1f}' for t in ms)}]")


def _first_at(res: dict, substr: str) -> int:
    hits = [tti for tti, ev in res["trace"] if substr in ev]
    if not hits:
        raise AssertionError(f"capstone: missing trace event {substr!r}")
    return hits[0]


def _check_ladder(res: dict, art: str) -> None:
    """Every assertion of tests/test_capstone.py::
    test_full_stack_over_the_air, on a run that wrote its artifacts into
    art."""
    for key in ("registered", "mme_registered", "rrc_connected", "echo_ok",
                "as_secured", "srb_integrity_on"):
        if not res[key]:
            raise AssertionError(f"capstone ladder: {key} is false")
    if res["ue_ip"] == 0 or res["srb_int_failures"] != 0:
        raise AssertionError(f"capstone ladder: {res}")
    events = [ev for _, ev in res["trace"]]
    if not next(i for i, e in enumerate(events)
                if "SecurityModeCommand" in e) < \
            next(i for i, e in enumerate(events)
                 if "AS security activated" in e):
        raise AssertionError("capstone ladder: SMC after AS activation")
    runs = res["phy_runs"]
    if runs["prach"] < 1 or runs["dl"] < 10 or runs["ul"] < 5:
        raise AssertionError(f"capstone ladder: phy_runs {runs}")
    # (earlier, strictly earlier?, later), as the reference test orders them
    for a, strict, b in (
            ("UE camped", False, "received SI"),
            ("received SI", True, "sent PRACH"),
            ("sent PRACH", False, "detected preamble"),
            ("detected preamble", True, "matched RAR"),
            ("matched RAR", True, "Msg3 -> C-RNTI"),
            ("Msg3 -> C-RNTI", False, "won contention resolution"),
            ("won contention", True, "forwarding initial NAS"),
            ("forwarding initial NAS", True, "DRB established"),
            ("DRB established", False, "queued uplink IP packet"),
            ("queued uplink IP", True, "received IP packet")):
        ta, tb = _first_at(res, a), _first_at(res, b)
        if not (ta < tb if strict else ta <= tb):
            raise AssertionError(f"capstone ladder: {a} at {ta}, {b} at {tb}")
    recs = read_pcap(os.path.join(art, "capstone.pcap"))
    kinds = {(k, d) for _, k, d, _, _ in recs}
    ul_macs = [p for _, k, d, _, p in recs if k == KIND_MAC and d == DIR_UL]
    if (len(recs) < 10 or (KIND_MAC, DIR_UL) not in kinds
            or (KIND_MAC, DIR_DL) not in kinds
            or not any(k == KIND_IP for _, k, _, _, _ in recs)
            or not any(p[0] & 0x1F == 0 for p in ul_macs)):
        raise AssertionError(f"capstone ladder: pcap {len(recs)} records, "
                             f"{kinds}")
    msc = open(os.path.join(art, "capstone.msc")).read()
    for label in ("PRACH", "RRCConnectionRequest", "InitialUEMessage",
                  "DownlinkNASTransport", "GTP-U"):
        if label not in msc:
            raise AssertionError(f"capstone ladder: MSC missing {label}")


def _capstone_run(cfg: dict, dev, art: str | None = None):
    """FullStackSim on dev with its PHY timed; (sim, result, timers,
    seconds, v2 launches by shape)."""
    sim = FullStackSim(CapstoneConfig(**cfg), artifact_dir=art, device=dev)
    timers = _capstone_timers(sim)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    return sim, res, timers, time.perf_counter() - t0, launch_shapes()


def _only_v2(shapes: dict, what: str) -> None:
    if not shapes or any(k[0] != "turbo_half_iter" for k in shapes):
        raise AssertionError(f"{what}: launches {shapes}; v2 must launch "
                             "and nothing else")


def check_small_capstone(dev) -> dict:
    """Phase 39: FullStackSim at the reference test's size (25 PRB, 12 dB,
    seed 0; decoder window 240 on both sides) on the CPU and on the card:
    the result (trace, TTIs, PHY runs, every flag), the pcap bytes and the
    MSC text equal; v2 launches on the card and nothing else. Returns the
    v2 launches by shape."""
    os.makedirs("build", exist_ok=True)
    cfg = dict(CAPSTONE_LADDER, decoder_window=TURBO_W)
    out = {}
    for d in ("cpu", dev):
        art = f"build/capstone_small_{d}"
        sim = FullStackSim(CapstoneConfig(**cfg), artifact_dir=art, device=d)
        reset_launch_counts()
        t0 = time.perf_counter()
        res = sim.run()
        res.pop("artifacts")
        out[d] = (res, open(f"{art}/capstone.pcap", "rb").read(),
                  open(f"{art}/capstone.msc").read(), launch_shapes(),
                  time.perf_counter() - t0)
    (a, pa, ma, _, ta), (b, pb, mb, shapes, tb) = out["cpu"], out[dev]
    print(f"small capstone 25 PRB: {a['ttis']} TTIs, PHY runs "
          f"{a['phy_runs']}, {len(a['trace'])} trace events, pcap {len(pa)} "
          f"bytes, MSC {len(ma)} chars; CPU {ta:.1f} s, card {tb:.1f} s; "
          f"card v2 launches by shape {shapes}", flush=True)
    for key in a:
        if a[key] != b[key]:
            raise AssertionError(f"small capstone: {key} differs: {a[key]} "
                                 f"against {b[key]}")
    if pa != pb or ma != mb:
        raise AssertionError("small capstone: pcap or MSC differs")
    _check_ladder(b, f"build/capstone_small_{dev}")
    _only_v2(shapes, "small capstone")
    return shapes


def capstone_full_width(dev) -> tuple:
    """Phase 40: FullStackSim at 100 PRB: the reference test's ladder (12
    dB, seed 0) with every assertion of tests/test_capstone.py::
    test_full_stack_over_the_air and the JAX run's 53 TTIs and PHY runs;
    the big-NAS ladder (seed 3, 450 B) and the MT attach through paging,
    each with its reference test's assertions. The ms of each DL, UL and
    PRACH PHY TTI and of the ladder's DCI blind decodes and turbo decodes
    (synced), v2's
    launches by shape and each run's seconds. Returns
    (v2 launches by shape over the three runs, the ladder's sim)."""
    os.makedirs("build", exist_ok=True)
    art = "build/capstone_100"
    # the ladder's DCI blind decodes and turbo decodes (DL and UL), timed
    # (synced) where the receivers call them
    blind, decode = capstone_mod.dci_blind_decode, DlschCodec.decode
    dci_ms, dec_ms = [], []

    def synced(fn, into):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return timed
    capstone_mod.dci_blind_decode = synced(blind, dci_ms)
    DlschCodec.decode = synced(decode, dec_ms)
    try:
        sim, res, ms, dt, shapes = _capstone_run(
            dict(CAPSTONE_LADDER, n_rb=100), dev, art)
    finally:
        capstone_mod.dci_blind_decode, DlschCodec.decode = blind, decode
    total = dict(shapes)
    print(f"capstone 100 PRB ladder: {res['ttis']} TTIs (JAX on the CPU: "
          f"{CAPSTONE_JAX_100['ttis']}), PHY runs {res['phy_runs']} (JAX: "
          f"{CAPSTONE_JAX_100['phy_runs']}), {dt:.2f} s; v2 launches by "
          f"shape {shapes}", flush=True)
    dl = [a + b for a, b in zip(ms["dl_tx"], ms["dl_rx"])]
    print(f"  DL PHY TTI (transmit + noise + demod, blind receive): "
          f"{_ms_line(dl)}; "
          f"transmit {_ms_line(ms['dl_tx'])}; receive {_ms_line(ms['dl_rx'])}"
          f"\n  UL PHY TTI: {_ms_line(ms['ul'])}\n  PRACH TTI: "
          f"{_ms_line(ms['prach'])}\n  DCI blind decodes: {len(dci_ms)} "
          f"calls, {sum(dci_ms):.1f} ms, {sum(dci_ms) / sum(dl):.1%} of the "
          f"DL PHY TTIs' {sum(dl):.1f} ms ({_ms_line(dci_ms)})\n  turbo "
          f"decodes (DL and UL): {len(dec_ms)} calls, {sum(dec_ms):.1f} ms, "
          f"{sum(dec_ms) / (sum(dl) + sum(ms['ul'])):.1%} of the DL and UL "
          f"PHY TTIs' ({_ms_line(dec_ms)})", flush=True)
    _check_ladder(res, art)
    if res["ttis"] != CAPSTONE_JAX_100["ttis"] or \
            res["phy_runs"] != CAPSTONE_JAX_100["phy_runs"]:
        raise AssertionError(f"capstone 100 PRB: {res['ttis']} TTIs, "
                             f"{res['phy_runs']}")
    _only_v2(shapes, "capstone 100 PRB")

    big, rb, ms_b, dt, shapes = _capstone_run(
        dict(CAPSTONE_BIG_NAS, n_rb=100), dev)
    total = _sum_shapes(total, shapes)
    tbs = big.dl.codec(big.cfg.ded).cfg.tbs // 8
    print(f"capstone 100 PRB big NAS (450 B): {rb['ttis']} TTIs, PHY runs "
          f"{rb['phy_runs']}, reassembled {rb['big_nas_ok']}, dedicated TBS "
          f"{tbs} B, {dt:.2f} s; UL {_ms_line(ms_b['ul'])}", flush=True)
    if not (rb["registered"] and rb["echo_ok"] and rb["big_nas_ok"]
            and tbs < 250):
        raise AssertionError(f"capstone big NAS: {rb}")
    _only_v2(shapes, "capstone big NAS")

    mt, rm, ms_m, dt, shapes = _capstone_run(dict(CAPSTONE_MT, n_rb=100),
                                             dev, "build/capstone_100_mt")
    total = _sum_shapes(total, shapes)
    print(f"capstone 100 PRB MT attach: {rm['ttis']} TTIs, PHY runs "
          f"{rm['phy_runs']}, paged {rm['paged']}, paging occasions "
          f"monitored {rm['po_monitored']}, {dt:.2f} s", flush=True)
    if not (rm["paged"] and rm["registered"] and rm["echo_ok"]
            and 1 <= rm["po_monitored"] <= 3):
        raise AssertionError(f"capstone MT attach: {rm}")
    order = ["MME pages", "UE paged (MT)", "sent PRACH"]
    if not _first_at(rm, order[0]) < _first_at(rm, order[1]) < \
            _first_at(rm, order[2]):
        raise AssertionError("capstone MT attach: paging order")
    t_page = _first_at(rm, "eNB transmits Paging")
    if not is_paging_occasion(PagingConfig(default_paging_cycle=0,
                                           paging_nb=2),
                              ue_paging_id(mt.cfg.imsi), t_page // 10,
                              t_page % 10):
        raise AssertionError(f"capstone MT attach: page at {t_page} is not "
                             "the UE's paging occasion")
    _only_v2(shapes, "capstone MT attach")
    print(f"v2 launches by shape over the three 100 PRB runs: {total}",
          flush=True)
    return total, sim


# The multi-UE tests' configurations (tests/test_capstone_multiue.py) and
# what the JAX package gives at 100 PRB on the CPU.
MULTIUE_PF = (dict(n_rb=100, snr_db=18.0, seed=1, max_ttis=900),
              dict(n_ues=4, scheduler="pf", ue_snr_spread_db=9.0))
MULTIUE_HO = (dict(n_rb=100, snr_db=15.0, seed=2, max_ttis=700),
              dict(n_ues=2))
MULTIUE_JAX_100 = dict(pf_ttis=60, pf_cqis=[10, 11, 13, 15],
                       pf_mcs=[16, 22], ho_ttis=54, ho_pci=3,
                       ho_crntis=(17922, 256))


def _multiue_run(case, dev, art=None):
    cfg, mk = case
    sim = MultiUeSim(CapstoneConfig(**cfg), device=dev, artifact_dir=art,
                     **mk)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    return sim, res, time.perf_counter() - t0, launch_shapes()


def multiue_full_width(dev) -> tuple:
    """Phase 41: MultiUeSim at 100 PRB: 4 UEs with the PF scheduler on
    measured CQI and a 9 dB spread (18 dB, seed 1), then 2 UEs (15 dB,
    seed 2) followed by HandoverPhySim; the gates are the reference tests'
    assertions, and the counts print beside the JAX run's at 100 PRB; ms
    a TTI. Returns (v2 launches by shape, the PF sim)."""
    os.makedirs("build", exist_ok=True)
    pf, res, dt, shapes = _multiue_run(MULTIUE_PF, dev)
    total = dict(shapes)
    cqis = list(res["reported_cqis"].values())
    mcs = sorted(set().union(*res["dl_mcs_used"].values()))
    want = MULTIUE_JAX_100
    print(f"multi-UE PF 4 UEs 100 PRB: {res['ttis']} TTIs (JAX on the CPU: "
          f"{want['pf_ttis']}), reported CQIs {sorted(cqis)} (JAX: "
          f"{want['pf_cqis']}), DL grants {res['dl_grants_by_ue']}, MCS used "
          f"{mcs} (JAX: {want['pf_mcs']}), FDM UL TTIs {res['fdm_ul_ttis']}, "
          f"collisions {res['collisions']}; {dt:.2f} s, "
          f"{dt / res['ttis'] * 1e3:.1f} ms a TTI; v2 launches by shape "
          f"{shapes}", flush=True)
    if not (all(res["registered"]) and all(res["echo_ok"])):
        raise AssertionError(f"multi-UE PF: {res}")
    if len(cqis) != 4 or max(cqis) - min(cqis) < 2:
        raise AssertionError(f"multi-UE PF: CQIs {cqis}")
    if len(res["dl_grants_by_ue"]) != 4 or \
            min(res["dl_grants_by_ue"].values()) < 1:
        raise AssertionError(f"multi-UE PF: grants {res['dl_grants_by_ue']}")
    if len(mcs) < 2:
        raise AssertionError(f"multi-UE PF: MCS used {res['dl_mcs_used']}")
    _only_v2(shapes, "multi-UE PF")

    art = "build/capstone_multiue_100"
    two, res, dt, shapes = _multiue_run(MULTIUE_HO, dev, art)
    total = _sum_shapes(total, shapes)
    reset_launch_counts()
    t0 = time.perf_counter()
    out = HandoverPhySim(two).run()
    torch.cuda.synchronize()
    dt_ho = time.perf_counter() - t0
    total = _sum_shapes(total, launch_shapes())
    print(f"multi-UE 2 UEs 100 PRB: {res['ttis']} TTIs (JAX: "
          f"{want['ho_ttis']}), C-RNTIs {res['crntis']}, FDM UL TTIs "
          f"{res['fdm_ul_ttis']}, {dt:.2f} s ({dt / res['ttis'] * 1e3:.1f} ms"
          f" a TTI); handover to PCI {out['target_pci']} (JAX: "
          f"{want['ho_pci']}), C-RNTI {out['source_crnti']} -> "
          f"{out['target_crnti']} (JAX: {want['ho_crntis'][0]} -> "
          f"{want['ho_crntis'][1]}), {dt_ho:.2f} s", flush=True)
    if not (all(res["registered"]) and all(res["echo_ok"])
            and res["artifacts"]["pcap_records"] > 0):
        raise AssertionError(f"multi-UE 2 UEs: {res}")
    evts = out["trace"]
    if not (out["target_pci"] == 3
            and out["target_crnti"] != out["source_crnti"]
            and any("PRACH" in e or "preamble" in e for e in evts)
            and any("path switched" in e for e in evts)
            and any("post-handover IP packet" in e for e in evts)):
        raise AssertionError(f"handover: {out}")
    _only_v2(total, "multi-UE and handover")
    print(f"v2 launches by shape over the multi-UE runs: {total}",
          flush=True)
    return total, pf


def check_kernels_capstone(dev, gen, timings, launched: dict) -> list:
    """Every (v2, shape) that phases 39-41 launched against its plain
    version on random inputs of that shape, bit for bit (batch-1 rows of
    one code block: the common, dedicated, Msg3 and UL grants, and the
    MCS that PF's CQIs picked). Returns [(kernel, launch key, row)]."""
    out = []
    for name, key in sorted(launched, key=str):
        rows, N, W, U = key
        row = _hold_v2("capstone", rows, N, W, U, dev, gen, timings)
        out.append((name, key, row))
    return out


# The flagship (phase 5's configuration) for the observability phase.
FLAGSHIP_CFG = dict(mcs=26, n_rb=100, channel="EVA", n_rx=1,
                    n_harq_rounds=1, batch=BATCH, est_mode="joint",
                    n_turbo_iter=8)


def observability_flagship(dev) -> dict:
    """Phase 42: DlsimFading at the flagship configuration. sweep with
    profile=True prints the time_meas table with dlsim.tx_encode and
    dlsim.round0(chan+rx+decode), each counted once a trial; the step time
    with the profiler on and off, in turns in this call; then trace_dir
    writes a trace holding the dlsim.step span and turbo_half_iter_kernel
    device events. Runs after every other path but phase 16's: the trace
    holds a profiler session."""
    sim = DlsimFading(DlsimFadingConfig(**FLAGSHIP_CFG), device=dev)
    profiler.reset_meas()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sim.sweep([24.0], n_frames=4 * BATCH, profile=True)
    table = buf.getvalue()
    print(table, end="", flush=True)
    stats = profiler.get_meas()
    for name in ("dlsim.tx_encode", "dlsim.round0(chan+rx+decode)"):
        if name not in table or stats.get(name, (0,))[0] != 4:
            raise AssertionError(f"profile table: {name} missing or not "
                                 f"counted 4 times: {stats}")
    n0 = np.float32(10.0 ** (-2.4))
    W, ev = sim.wiener(24.0), sim.err_var(24.0)
    gen = torch.Generator(device=dev).manual_seed(3)
    n_steps, times = 10, {True: [], False: []}
    for _ in range(2):
        for on in (False, True, True, False):
            profiler.enable(on)
            sim.step(gen, n0, W, ev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_steps):
                sim.step(gen, n0, W, ev)
            torch.cuda.synchronize()
            times[on].append((time.perf_counter() - t0) / n_steps * 1e3)
    profiler.enable(True)
    on, off = np.median(times[True]), np.median(times[False])
    print(f"flagship step with the profiler on: {on:.2f} ms (median of "
          f"{len(times[True])} windows of {n_steps}: "
          f"{', '.join(f'{t:.2f}' for t in times[True])}); off: {off:.2f} ms"
          f" ({', '.join(f'{t:.2f}' for t in times[False])}); on - off "
          f"{on - off:+.2f} ms", flush=True)
    d = "build/trace_flagship"
    shutil.rmtree(d, ignore_errors=True)
    sim.sweep([24.0], n_frames=BATCH, verbose=False, trace_dir=d)
    found = trace_artifacts(d)
    if len(found) != 1:
        raise AssertionError(f"trace_dir wrote {found}")
    events = json.load(open(found[0]))["traceEvents"]
    # record_function's span on the host, and its mirror on the device's
    # timeline (category gpu_user_annotation)
    spans = [e for e in events if e.get("name") == "dlsim.step"
             and e.get("cat") == "user_annotation"]
    mirrored = [e for e in events if e.get("name") == "dlsim.step"
                and e.get("cat") == "gpu_user_annotation"]
    kernels_seen = [e for e in events
                    if str(e.get("cat", "")).lower() == "kernel"
                    and "turbo_half_iter_kernel" in e.get("name", "")]
    print(f"trace {found[0]}: {os.path.getsize(found[0])} bytes, "
          f"{len(events)} events, dlsim.step spans {len(spans)} on the host "
          f"({spans[0]['dur'] / 1e3 if spans else 0:.2f} ms) and "
          f"{len(mirrored)} on the device's timeline, "
          f"turbo_half_iter_kernel device events {len(kernels_seen)}",
          flush=True)
    if len(spans) != 1 or not kernels_seen:
        raise AssertionError("the trace lacks the dlsim.step span or the "
                             "turbo_half_iter_kernel device events")
    return {"profiler_on_ms": on, "profiler_off_ms": off}


def runtime_20mhz(dev) -> dict:
    """Phase 43: the native runtime at 20 MHz. Ring, ITTI queue and
    scheduler round trips; a SoftModem fed a 100 PRB framegen frame ten
    times over (100 subframes of 30,720 samples), paced at 1 ms with 2
    workers, whose `process` demodulates each subframe's OFDM symbols and
    correlates it against the PSS replicas on the card: the PSS (NID2 0,
    at its sample) in subframes 0 and 5 of every frame, each peak over ten
    times any other subframe's of its frame, every subframe done; missed
    deadlines and µs a subframe printed, not gated. Then an RrhLoopback
    round trip of a 100 PRB subframe with AWGN, demodulated on the card:
    hard decisions exact. The SoftModem runs again with 1 worker, for
    comparison (not gated)."""
    from openair4g_tpu_torch.runtime import (MessageQueues, RingBuffer,
                                             SoftModem, SubframeScheduler)
    from openair4g_tpu_torch.runtime.fronthaul import RrhLoopback
    rb = RingBuffer(64)
    if rb.write(b"a" * 48) != 48 or rb.read(32) != b"a" * 32 or \
            rb.write(b"b" * 40) != 40 or rb.fill != 56:
        raise AssertionError("ring buffer round trip")
    mq = MessageQueues()
    mq.send(3, 42, b"hello")
    if mq.recv(3) != (42, b"hello") or mq.recv(5, timeout_s=0.01) is not None:
        raise AssertionError("ITTI queue round trip")
    seen = []
    r = SubframeScheduler(2, 100).run(lambda sf: seen.append(sf) or 0, 50,
                                      realtime=False)
    if r["done"] != 50 or sorted(seen) != list(range(50)):
        raise AssertionError(f"scheduler free run: {r}")

    fp = FrameParms(n_rb=100)
    spt = fp.samples_per_tti
    frame = generate_frame(CellConfig(n_rb=100, n_prb=100), device=dev)
    wave = np.tile(frame, 10)
    search = CellSearch(fp, capture_len=spt)

    def process(sf, samples):
        x = torch.as_tensor(np.array(samples), device=dev)[None]
        rgrid = ofdm_demodulate(x, fp)
        pos, nid2, _, peak = search.pss_correlate(x)
        power = rgrid.abs().square().mean()
        out = torch.stack([peak[0], nid2[0].float(), pos[0].float(), power])
        return out.cpu().numpy().tolist()

    modem = SoftModem(fp, process, n_workers=2, period_us=1000,
                      ring_subframes=128)
    process(0, wave[:spt])                 # first card calls outside it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for sf in range(20):
        process(sf, wave[sf * spt:(sf + 1) * spt])
    alone_us = (time.perf_counter() - t0) / 20 * 1e6
    fed = modem.feed(wave)
    t0 = time.perf_counter()
    stats = modem.run(100, realtime=True)
    dt = time.perf_counter() - t0
    res = dict(modem.results(100, timeout_s=5.0))
    print(f"SoftModem 20 MHz, 100 subframes of {spt} samples at 1 ms, 2 "
          f"workers: fed {fed}, done {stats.done}, results {len(res)}, "
          f"underruns {stats.underruns}, missed deadlines {stats.missed}, "
          f"{stats.mean_us:.1f} µs mean and {stats.max_us:.1f} µs max a "
          f"subframe, {dt * 1e3:.1f} ms for the run; `process` alone in this "
          f"thread {alone_us:.1f} µs a subframe (mean of 20)", flush=True)
    if fed != 100 or stats.done != 100 or len(res) != 100 or \
            stats.underruns:
        raise AssertionError(f"SoftModem: fed {fed}, {stats}, {len(res)} "
                             "results")
    pss_at = (fp.cp0 + fp.n_fft) + 5 * (fp.cp + fp.n_fft) + fp.cp
    for f in range(10):
        peaks = [res[10 * f + s][0] for s in range(10)]
        floor = max(p for s, p in enumerate(peaks) if s not in (0, 5))
        for s in (0, 5):
            peak, nid2, pos, _ = res[10 * f + s]
            if not (peak > 10 * floor and nid2 == 0 and pos == pss_at):
                raise AssertionError(f"SoftModem frame {f} subframe {s}: "
                                     f"peak {peak} (floor {floor}), NID2 "
                                     f"{nid2}, at {pos} (want {pss_at})")
    one = SoftModem(fp, process, n_workers=1, period_us=1000,
                    ring_subframes=128)
    one.feed(wave)
    st1 = one.run(100, realtime=True)
    if st1.done != 100 or len(one.results(100, timeout_s=5.0)) != 100:
        raise AssertionError(f"SoftModem with one worker: {st1}")
    print(f"  the same with 1 worker: missed deadlines {st1.missed}, "
          f"{st1.mean_us:.1f} µs mean and {st1.max_us:.1f} µs max a "
          "subframe", flush=True)
    print(f"  PSS in subframes 0 and 5 of all 10 frames at sample {pss_at}; "
          f"peak {res[0][0]:.2f} against at most "
          f"{max(res[i][0] for i in range(100) if i % 5):.3f} elsewhere",
          flush=True)

    gm = make_grid_map(100, 1)
    rng = np.random.default_rng(1)
    qpsk = ((1 - 2 * rng.integers(0, 2, gm.n_data_re))
            + 1j * (1 - 2 * rng.integers(0, 2, gm.n_data_re))
            ).astype(np.complex64) / np.sqrt(2)
    grid = fill_grid(torch.as_tensor(qpsk[None], device=dev), gm)
    tx = ofdm_modulate(grid, fp).cpu().numpy()[0]
    n0 = 1e-4
    air = np.random.default_rng(2)
    rrh = RrhLoopback(channel_hook=lambda s: s + (
        (air.standard_normal(len(s)) + 1j * air.standard_normal(len(s)))
        * np.sqrt(n0 / 2)).astype(np.complex64))
    if not rrh.write(spt, tx):
        raise AssertionError("RrhLoopback refused a write one subframe ahead")
    rrh.read(spt)
    ts, rx = rrh.read(spt)
    y = extract_data_res(ofdm_demodulate(
        torch.as_tensor(rx[None], device=dev), fp), gm).cpu().numpy()[0]
    ok = (np.sign(y.real) == np.sign(qpsk.real)).mean(), \
        (np.sign(y.imag) == np.sign(qpsk.imag)).mean()
    print(f"RrhLoopback 100 PRB subframe at n0 {n0}: read at {ts}, "
          f"{len(qpsk)} QPSK REs, hard decisions right {ok[0]:.4f} (I) "
          f"{ok[1]:.4f} (Q); TX blocks {rrh.stats.tx_blocks}, late "
          f"{rrh.stats.tx_late}, least lead {rrh.stats.tx_lead_min}",
          flush=True)
    if ts != spt or ok != (1.0, 1.0):
        raise AssertionError(f"RrhLoopback: ts {ts}, decisions {ok}")
    return {"missed": stats.missed, "mean_us": stats.mean_us,
            "max_us": stats.max_us, "alone_us": alone_us,
            "one_worker_missed": st1.missed}


# Phase 44: the flagship sharded over ranks, the distributed sweep and the
# time-sharded PSS correlation, each rank a process of its own on the card.
PAR_TIMEOUT = 300            # seconds a spawn may take, and each collective
PAR_AWGN = dict(mcs=4, n_rb=25)            # the distributed command line's
# Its waterfall on the card: 126/128 errors at -3 dB, none at -2 dB; the
# sweep stops after the first point without an error.
PAR_SNRS, PAR_FRAMES = [-3.0, -2.5, -2.0], 128
# The flagship's (kernel, shape)s held in phase 3.
# The v2 rows of phases 17, 23 and 35, in the kernels line's order.
EARLIER_V2_KEYS = [("turbo_half_iter", (rows, n, TURBO_W, TURBO_U))
                   for rows, n in ((UL_TURBO_ROWS, TURBO_W * TURBO_NW),
                                   (MBMS_TURBO_ROWS, MBMS_TURBO_N),
                                   (OAISIM_ROWS, OAISIM_N))]
PHASE3_KEYS = {("turbo_half_iter", (TURBO_ROWS, TURBO_W * TURBO_NW, TURBO_W,
                                    TURBO_U)),
               ("mrc_llr", ((BATCH, N_DATA, 1), 6, False)),
               ("mrc_llr", ((BATCH, N_PDCCH_RE, 1), 2, True)),
               ("mrc_llr", ((BATCH, N_DATA, 2), 4, False))}


def _pss_captures(fp) -> tuple:
    """[6, 155,648] 20 MHz captures (Syncsim's 5 ms plus one symbol): a
    PSS replica inside the first of four blocks, one straddling each
    boundary of four blocks, one at the last position the search takes,
    and one in noise. Returns (captures, true positions, NID2s)."""
    L, n = 5 * fp.samples_per_tti + fp.n_fft, fp.n_fft
    q = L // 4
    pos = [5000, q - 100, 2 * q - 1000, 3 * q - 5, L - n - 1, 100000]
    g = np.random.default_rng(44)
    r = np.zeros((len(pos), L), np.complex64)
    r[-1] = (g.normal(size=L) + 1j * g.normal(size=L)) * 0.2
    for b, p in enumerate(pos):
        r[b, p:p + n] += pss_time_replica(b % 3, n) * (4 if b == 5 else 1)
    return r, pos, [b % 3 for b in range(len(pos))]


def _ranks(work, world: int, backend: str, jobs: list) -> list:
    """checks.run_jobs(jobs) in `world` ranks on the card; each job's
    value must be the same on every rank (times aside). Returns the
    ranks' spawn results."""
    out = spawn("openair4g_tpu_torch.parallel.checks:run_jobs", world,
                backend=backend, workdir=work, kwargs={"jobs": jobs},
                timeout=PAR_TIMEOUT)
    for r, res in enumerate(out):
        lib = res["kernel_library"]     # None: the rank launched no kernel
        if res["nvcc_ran"] or lib not in (None, kernels.build_info["path"]) \
                or (res["launch_shapes"] and lib is None):
            raise AssertionError(f"rank {r} did not load phase 2's library: "
                                 f"{lib}")
        for (name, _), a, b in zip(jobs, out[0]["value"], res["value"]):
            if isinstance(a, dict):
                a = {k: v for k, v in a.items() if not k.endswith("ms")}
                b = {k: v for k, v in b.items() if not k.endswith("ms")}
            np.testing.assert_equal(b, a, err_msg=f"{name}: rank {r} of "
                                    f"{world} against rank 0")
    return out


def parallel_on_card(dev, gen, timings, held_keys: set) -> dict:
    """Phase 44: the parallel modules on the card, every rank a process
    that loads phase 2's library. a. world 1 on NCCL: entry() once, the
    flagship sharded (batch 128, 26 dB, 2 iterations: the TB errors of
    the same round in this process on the same draws, no DCI miss), the
    distributed sweep of DlsimAwgn at 16 a rank and the PSS correlation
    at n_t = 1; b. world 2 on gloo, both ranks on cuda:0:
    the flagship at 64 a rank equals a.'s counts, the sweep at 8 a rank
    equals a.'s rows and the sim's own run_snr at batch 16, a sweep
    preempted after its first point and resumed from its checkpoint
    equals the unbroken one, and the PSS correlation at n_t = 2; c. world
    4 on gloo: the PSS correlation at n_t = 4. Every correlation's pos
    and NID2 equal CellSearch.pss_correlate on the whole capture. d.
    every (kernel, shape) the ranks launched that no earlier phase held,
    against its plain version. Returns {"held": [(kernel, key, row)],
    "launched": the ranks' launches by (kernel, shape)}."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.cuda.empty_cache()
    work = os.path.abspath(f"build/parallel/{os.getpid()}")
    shutil.rmtree(work, ignore_errors=True)
    fp = FrameParms(n_rb=100)
    capture, true_pos, true_nid2 = _pss_captures(fp)
    pos_ref, nid2_ref, _, _ = CellSearch(fp).pss_correlate(
        torch.as_tensor(capture, device=dev))
    pos_ref, nid2_ref = pos_ref.tolist(), nid2_ref.tolist()
    # the noise may move the flat-topped peak by a sample or two
    if pos_ref[:-1] != true_pos[:-1] or nid2_ref != true_nid2 \
            or abs(pos_ref[-1] - true_pos[-1]) > 2:
        raise AssertionError(f"CellSearch: {pos_ref} {nid2_ref}")

    def pss(n_t):
        return ("pss_correlate", dict(device=dev, n_ue=1, n_t=n_t,
                                      n_fft=fp.n_fft, capture=capture))

    def flagship(bpd):
        return ("flagship", dict(device=dev, bpd=bpd, n_turbo_iter=2,
                                 snr_db=26.0))

    def sweep(bpd, **kw):
        return ("bler_sweep", dict(device=dev, bpd=bpd, snrs=PAR_SNRS,
                                   n_frames=PAR_FRAMES, sim=PAR_AWGN, **kw))

    ckpt = os.path.join(work, "sweep.json")
    chunks = PAR_FRAMES // 16
    runs = {
        "a": (1, "nccl", [("entry_point", dict(device=dev)), flagship(128),
                          sweep(16), pss(1)]),
        "b": (2, "gloo", [flagship(64), sweep(8),
                          sweep(8, ckpt_path=ckpt, preempt_after=chunks),
                          sweep(8, ckpt_path=ckpt), pss(2)]),
        "c": (4, "gloo", [pss(4)])}
    got, launched = {}, {}
    for label, (world, backend, jobs) in runs.items():
        t0 = time.perf_counter()
        out = _ranks(os.path.join(work, label), world, backend, jobs)
        got[label] = out[0]["value"]
        launched = _sum_shapes(launched, *(r["launch_shapes"] for r in out))
        print(f"44{label}: world {world} on {backend}, every rank on {dev}:0"
              f", {time.perf_counter() - t0:.1f} s with the ranks' start "
              f"(rank seconds {[round(r['seconds'], 1) for r in out]}); "
              "no rank ran nvcc; each that launched a kernel loaded phase 2's"
              " library", flush=True)
        for r, res in enumerate(out):
            for (name, _), v in zip(jobs, res["value"]):
                if name in ("flagship", "pss_correlate"):
                    times = {k: round(x, 3) for k, x in v.items()
                             if k.endswith("ms")}
                    print(f"  rank {r} {name}: {times} ({smi}; the ranks "
                          "share the card, so no rate is claimed)",
                          flush=True)

    # a. world 1 on NCCL, against the flagship's round 0 in this process
    # on the same draws (seed 0 at batch 128), with no process group
    sim = DlsimFading(DlsimFadingConfig(**dict(FLAGSHIP_CFG, n_turbo_iter=2)),
                      device=dev)
    tb, taps, noise = sim.draw(torch.Generator(device=dev).manual_seed(0))
    one, _ = sim.round(0, tb, sim.dlsch.encode_to_d(tb), taps[0], noise[0],
                       10.0 ** -2.6, sim.wiener(26.0), sim.err_var(26.0))
    one = (int((~one.ok).sum()), int((~one.dci_ok).sum()), BATCH)
    ok, bit_errs = got["a"][0]
    fa, rows_a, pss_a = got["a"][1:]
    print(f"44a entry(): {ok}/8 TBs, {bit_errs} bit errors; flagship "
          f"sharded at 128: {fa}; the same round in one process (errs, "
          f"DCI misses, trials) {one}; sweep rows {rows_a}; PSS n_t = 1 "
          f"{pss_a['pos'].tolist()} {pss_a['nid2'].tolist()} "
          f"({pss_a['halo']})", flush=True)
    if (fa["errs"], fa["dci_miss"], fa["trials"]) != one or one[1] != 0 \
            or fa["backend"] != "nccl":
        raise AssertionError(f"44a flagship: {fa}, one process {one}")
    # b. world 2 on gloo, both ranks on one card
    fb, rows_b, preempted, resumed, pss_b = got["b"]
    sim = DlsimAwgn(DlsimConfig(batch=16, **PAR_AWGN), device=dev)
    rows_1 = []
    for s in PAR_SNRS:
        errs, trials = sim.run_snr(s, PAR_FRAMES)
        rows_1.append((s, errs, trials))
        if errs == 0:
            break
    print(f"44b flagship 2 x 64: {fb}; sweep rows {rows_b}, world 1 "
          f"{rows_a}, run_snr at batch 16 {rows_1}; preempted after "
          f"{chunks} chunks -> {preempted}, resumed {resumed}; PSS n_t = 2 "
          f"({pss_b['halo']})", flush=True)
    if (fb["errs"], fb["dci_miss"], fb["trials"]) != (
            fa["errs"], fa["dci_miss"], fa["trials"]) \
            or fb["backend"] != "gloo":
        raise AssertionError(f"44b flagship {fb} against 44a {fa}")
    rows_a, rows_b, resumed = ([tuple(r) for r in x]
                               for x in (rows_a, rows_b, resumed))
    if not rows_b == rows_a == rows_1 or preempted is not None \
            or resumed != rows_b:
        raise AssertionError(f"44b sweeps: world 2 {rows_b}, world 1 "
                             f"{rows_a}, run_snr {rows_1}, resumed {resumed}")
    if pss_b["halo"] != "host copy (gloo send/recv)":
        raise AssertionError(f"44b halo: {pss_b['halo']}")
    # c. the time-sharded correlation against CellSearch
    for n_t, res in ((1, pss_a), (2, pss_b), (4, got["c"][0])):
        if res["pos"].tolist() != pos_ref or res["nid2"].tolist() != \
                nid2_ref:
            raise AssertionError(f"44c n_t = {n_t}: {res}, CellSearch "
                                 f"{pos_ref} {nid2_ref}")
        print(f"44c PSS n_t = {n_t} ({res['backend']}, halo: {res['halo']}):"
              f" pos {res['pos'].tolist()} and NID2 {res['nid2'].tolist()} "
              "equal CellSearch.pss_correlate on the whole capture; peak "
              f"{np.round(res['peak'], 3).tolist()}", flush=True)
    # d. every (kernel, shape) the ranks launched that no phase held
    print(f"44d the ranks' launches: {launched}", flush=True)
    held = _hold_each(launched, held_keys, "44 ranks", dev, gen, timings)
    for kernel in ("turbo_half_iter", "mrc_llr"):
        if not any(k == kernel for k, _ in launched):
            raise AssertionError(f"no rank launched {kernel}")
    shutil.rmtree(work, ignore_errors=True)
    return {"held": held, "launched": launched}


def _hold_demap(label: str, lead: tuple, Qm: int, n0_scalar: bool, dev, gen,
                timings) -> dict:
    """demap_llr at x [*lead] (n0 a number, or per RE) against its plain
    version within MRC_RTOL/ATOL; its time by CUDA events, queued for
    phase 16's device time. Returns the kernels-line row."""
    x = torch.view_as_complex(torch.randn(*lead, 2, generator=gen,
                                          device=dev)) * 0.7
    n0 = 0.05 if n0_scalar else \
        0.01 + torch.rand(*lead, generator=gen, device=dev)
    got, want = demap_llr_fused(x, n0, Qm), demap_llr_fused_ref(x, n0, Qm)
    torch.cuda.synchronize()
    err, ratio = _worst_ratio(got, want, MRC_RTOL, MRC_ATOL)
    kernel = functools.partial(demap_llr_fused, x, n0, Qm)
    ms = _time_ms(kernel, 50)
    plain = _time_ms(lambda: demap_llr_fused_ref(x, n0, Qm), 5)
    n_re = int(np.prod(lead))
    bound = _bound((8 + 4 * Qm + (0 if n0_scalar else 4)) * n_re,
                   10 * Qm * n_re)
    kind = "n0 scalar" if n0_scalar else "n0 per RE"
    print(f"demap_llr {label} Qm={Qm} {list(lead)} {kind}: max|diff| "
          f"{err:.3g}, max |diff|/(atol+rtol|ref|) {ratio:.3g} (must be "
          f"<= 1); kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bound['bound_ms']:.5f} ms ({bound['bound_by']})", flush=True)
    if not ratio <= 1.0:
        raise AssertionError(f"demap_llr {label} disagrees: {ratio}")
    row = {"shape": f"{label} {list(lead)} Qm={Qm} {kind}",
           "max_abs_err": err, "ms": ms, "plain_ms": plain, **bound}
    timings.append((f"demap_llr {label} Qm={Qm} REs={n_re}", kernel,
                    f"demap_llr_kernel<{Qm}>", row))
    return row


def _hold_each(launched: dict, held_keys: set, label: str, dev, gen,
               timings) -> list:
    """Every (kernel, launch key) of launched that no earlier phase held,
    against its plain version (v2 bit for bit, mrc_llr and demap_llr
    within rtol = atol = 3e-4), labelled with label and its launches.
    Returns [(kernel, key, row)]."""
    out = []
    for name, key in sorted(launched, key=str):
        if (name, key) in held_keys:
            continue
        what = f"{label} x{launched[name, key]}"
        if name == "mrc_llr":
            shape, Qm, n0_scalar = key
            row = _hold_mrc(what, shape[:-1], shape[-1], Qm, n0_scalar, dev,
                            gen, timings)
        elif name == "demap_llr":
            row = _hold_demap(what, *key, dev, gen, timings)
        elif name == "turbo_half_iter":
            row = _hold_v2(what, *key, dev, gen, timings)
        else:
            raise AssertionError(f"{name} {key} launched in {label}")
        out.append((name, key, row))
        held_keys.add((name, key))
    return out


# The bench's turbo cell: MCS 10 on 50 PRB, TBS 7,992 in 2 blocks of K =
# 4,032, so 512 TBs decode as 1,024 rows of N = 4,080 (17 windows of
# W = 240), the trellis' K + 3 positions padded from 4,035 on.
BENCH_TURBO = (1024, 4080, TURBO_W, TURBO_U)
BENCH_TURBO_PAD = 4032 + 3


def port_bench(dev, gen, timings, held_keys: set) -> dict:
    """Phase 45: the four cells of openair4g_tpu_torch.bench at bench.py's
    sizes and window counts, each with the launch counts set to 0 just
    before it and read just after. The flagship's first step decodes a
    TB; the turbo cell's fixed_8iter decode launches v2 2 x 8 times a
    call at BENCH_TURBO only and its dynamic stop fewer; the front end
    launches no kernel. Then v2 at BENCH_TURBO bit for bit, mrc_llr at
    the flagship cell's shapes within rtol = atol = 3e-4, and every other
    (kernel, shape) the cells launched that no phase held. Returns the
    cells' rows, their steps for phase 16 (label, fn), the launches by
    (kernel, shape) and the held rows."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cells, steps, launched = {}, [], {}
    for cell in bench.CELLS:
        reset_launch_counts()
        row, cell_steps = cell(dev)
        torch.cuda.synchronize()
        shapes = launch_shapes()
        launched[cell.__name__] = shapes
        row["card"] = smi
        cells[cell.__name__] = row
        print(f"bench {json.dumps(row)}", flush=True)
        steps += [(f"bench {cell.__name__} {label}", fn)
                  for label, fn in cell_steps.items()]
    per_call = cells["turbo"]["launches"]
    if per_call["fixed_8iter"] != {"turbo_half_iter": 16.0}:
        raise AssertionError(f"fixed_8iter decode launches {per_call}")
    if not 0 < per_call["earlystop_operating"].get(
            "turbo_half_iter", 0) < 16:
        raise AssertionError(f"earlystop_operating decode launches "
                             f"{per_call}")
    if set(launched["turbo"]) != {("turbo_half_iter", BENCH_TURBO)}:
        raise AssertionError(f"turbo cell launched {launched['turbo']}")
    kernels_of = {c: {name for name, _ in s} for c, s in launched.items()}
    if kernels_of["flagship"] != {"turbo_half_iter", "mrc_llr"} or \
            kernels_of["awgn"] != {"turbo_half_iter"} or \
            kernels_of["front_end"]:
        raise AssertionError(f"the cells launched {kernels_of}")
    for name, value in (("flagship", cells["flagship"]["value"]),
                        ("awgn", cells["awgn"]["value"]),
                        ("front_end", cells["front_end"]["value"]),
                        *cells["turbo"]["value"].items()):
        if not (np.isfinite(value) and value > 0):
            raise AssertionError(f"bench {name}: rate {value}")
    print(json.dumps(bench.last_line(list(cells.values()))), flush=True)

    turbo_row = _hold_v2("bench turbo cell", *BENCH_TURBO, dev, gen,
                         timings, pad_from=BENCH_TURBO_PAD)
    held_keys.add(("turbo_half_iter", BENCH_TURBO))
    for name, key in sorted(launched["flagship"], key=str):
        if name == "mrc_llr":      # held in phase 3 too; timed there
            shape, Qm, n0_scalar = key
            _hold_mrc("bench flagship", shape[:-1], shape[-1], Qm,
                      n0_scalar, dev, gen, [])
    total = _sum_shapes(*launched.values())
    return {"cells": cells, "steps": steps, "launched": total,
            "turbo_row": turbo_row,
            "held": _hold_each(total, held_keys, "45 bench", dev, gen,
                               timings)}


# Phase 46's band: a count of the port's against the TPU run's count at
# the same point, as |p1 - p2| over the pooled two-proportion standard
# deviation. Fixed before the first run on the card.
Z_BAND = 4.0
CAMPAIGN_TRIALS = 1024
# Keys of the committed turbo_roofline.json that name TPU units and have
# no counterpart on the card (the port's: bytes/ops ceilings, the plain
# half-iteration).
ROOFLINE_TPU_KEYS = {"vpu_ceiling_gbps", "mxu_ceiling_gbps",
                     "half_iteration_xla_ms"}


def _csv_counts(path: str, snr: float) -> tuple:
    """(err0, trials0) of the committed CSV's row at snr."""
    with open(path) as f:
        for line in f.read().splitlines()[1:]:
            cols = line.split(";")
            if abs(float(cols[0]) - snr) < 1e-6:
                return int(cols[4]), int(cols[5])
    raise AssertionError(f"{path}: no row at {snr} dB")


def _header(path: str) -> str:
    with open(path) as f:
        return f.readline().rstrip("\n")


def _in_band(what: str, k1: int, n1: int, k2: int, n2: int) -> None:
    z = two_proportion_z(k1, n1, k2, n2)
    print(f"46 {what}: {k1}/{n1} = {k1 / n1:.4f} on the card, {k2}/{n2} = "
          f"{k2 / n2:.4f} in the committed run (taken on a TPU): "
          f"{z:.2f} sd (band {Z_BAND})", flush=True)
    if not z <= Z_BAND:
        raise AssertionError(f"46 {what}: {z:.2f} sd outside the band")


def _keys_hold(what: str, committed: dict, ours: dict,
               skip: set = frozenset()) -> None:
    missing = set(committed) - set(ours) - skip
    if missing or not {"device", "seconds"} <= set(ours):
        raise AssertionError(f"46 {what}: keys {sorted(missing)} missing, "
                             f"or device/seconds: {sorted(ours)}")


def campaigns(dev, gen, timings, held_keys: set) -> dict:
    """Phase 46: each ported campaign program end to end through its
    command line (main(argv)) into a temporary --out-dir, at reduced
    trials; the counts where the committed TPU run has them within Z_BAND
    of those; every output with the committed file's keys (and CSV
    header) plus device and seconds; a second run of each skips every
    configuration (resume). Then every (kernel, shape) they launched that
    no phase held. Returns the launches by (kernel, shape) and the held
    rows."""
    out = os.path.abspath(f"build/campaigns/{os.getpid()}")
    shutil.rmtree(out, ignore_errors=True)
    n = str(CAMPAIGN_TRIALS)
    runs = [
        ("awgn_campaign", awgn_campaign, [n, "10", "--snr-range",
                                          "2.9:3.1"], ["mcs10"]),
        ("fidelity_campaign", fidelity_campaign,
         [n, f"{out}/fidelity/txdiv64.agg.json", "txdiv64", "--snrs",
          "13,14"], ["txdiv64"]),
        ("fidelity_campaign", fidelity_campaign,
         [n, f"{out}/fidelity/ulsim16.agg.json", "ulsim16", "--snrs", "3.0"],
         ["ulsim16"]),
        ("ulsim_campaign", ulsim_campaign,
         [n, "awgn10", "--snr-range", "2.75:2.75"], ["awgn10"]),
        ("prach_roc", prach_roc, ["4", f"{out}/prach/agg.json",
                                  "fmt0_ncs13"], ["fmt0_ncs13"]),
        ("fading_campaign", fading_campaign, ["256"],
         [name for name, *_ in fading_campaign.CORPUS]),
        ("doppler_campaign", doppler_campaign, ["256"],
         ["doppler_campaign"]),
        ("eva_ablation", eva_ablation, ["256"],
         [name for name, *_ in eva_ablation.CASES]),
        ("turbo_roofline", turbo_roofline, ["6144", "512", "8"],
         ["turbo_roofline"]),
        ("flagship_stages", flagship_stages, [], ["flagship_stages"]),
        ("flagship_profile", flagship_profile, [], ["flagship_profile"]),
        ("scale_campaign", scale_campaign, [], ["scale_campaign"]),
    ]
    dirs = {"fidelity_campaign": "fidelity", "prach_roc": "prach"}
    got = {}
    reset_launch_counts()
    for prog, mod, argv, names in runs:
        t0 = time.perf_counter()
        res = mod.main(argv + ["--out-dir",
                               f"{out}/{dirs.get(prog, prog)}"])
        got.setdefault(prog, {}).update({prog: res} if names == [prog]
                                        else res)
        print(f"46 {prog} {' '.join(argv)}: {time.perf_counter() - t0:.1f} "
              "s", flush=True)
    torch.cuda.synchronize()
    launched = launch_shapes()
    print(f"46 launches: {launch_counts()}", flush=True)
    for kernel in ("turbo_half_iter", "mrc_llr", "demap_llr"):
        if not any(k == kernel for k, _ in launched):
            raise AssertionError(f"no campaign launched {kernel}")

    # the counts against the committed TPU runs
    for snr in (2.9, 3.0, 3.1):
        _in_band(f"awgn mcs10 {snr} dB",
                 *_csv_counts(f"{out}/awgn_campaign/mcs10.csv", snr),
                 *_csv_counts("awgn_results/mcs10.csv", snr))
    committed = {name: json.load(open(f"{name}.json")) for name in (
        "awgn_campaign", "fidelity_campaign", "ulsim_campaign", "prach_roc",
        "fading_campaign", "doppler_campaign", "eva_ablation",
        "turbo_roofline", "scale_campaign")}
    for config, snrs in (("txdiv64", (13.0, 14.0)), ("ulsim16", (3.0,))):
        ours = {r[0]: r for r in got["fidelity_campaign"][config]["rows"]}
        ref = {r[0]: r for r in committed["fidelity_campaign"][config][
            "rows"]}
        for snr in snrs:
            _in_band(f"fidelity {config} {snr} dB", ours[snr][1],
                     ours[snr][2], ref[snr][1], ref[snr][2])
    _in_band("ulsim awgn10 2.75 dB",
             *_csv_counts(f"{out}/ulsim_campaign/awgn10.csv", 2.75),
             *_csv_counts("ulsim_results/awgn10.csv", 2.75))
    ours = got["prach_roc"]["fmt0_ncs13"]
    ref = committed["prach_roc"]["fmt0_ncs13"]
    r1 = next(r for r in ours["rows"] if r["threshold"] == 14.0)
    r2 = ref["operating_point"]
    if r2["threshold"] != 14.0:
        raise AssertionError(f"prach_roc.json's operating point {r2}")
    for what in ("det_rate", "fa_per_occasion"):
        _in_band(f"prach fmt0_ncs13 threshold 14 {what}",
                 round(r1[what] * ours["occasions"]), ours["occasions"],
                 round(r2[what] * ref["occasions"]), ref["occasions"])
    for name, *_ in fading_campaign.CORPUS:
        counts = [(d[name]["errs"][0], d[name]["reached"][0]) for d in (
            got["fading_campaign"], committed["fading_campaign"])]
        z = two_proportion_z(*counts[0], *counts[1])
        print(f"46 fading {name}: round 0 {counts[0]} on the card, "
              f"{counts[1]} committed: {z:.2f} sd (printed, not gated)",
              flush=True)

    # the committed files' keys and CSV headers
    for prog, first in (("awgn_campaign", "mcs10"),
                        ("fidelity_campaign", "txdiv64"),
                        ("fidelity_campaign", "ulsim16"),
                        ("ulsim_campaign", "awgn10"),
                        ("prach_roc", "fmt0_ncs13"),
                        ("fading_campaign", "test1"),
                        ("eva_ablation", "test1_ref")):
        _keys_hold(f"{prog} {first}", committed[prog][first],
                   got[prog][first])
    _keys_hold("doppler_campaign", committed["doppler_campaign"],
               got["doppler_campaign"]["doppler_campaign"])
    dop, cdop = got["doppler_campaign"]["doppler_campaign"], \
        committed["doppler_campaign"]
    if set(cdop["dl"][0]) != set(dop["dl"][0]) or set(
            cdop["dl"][0]["points"][0]) != set(dop["dl"][0]["points"][0]) \
            or set(cdop["prach"][0]) != set(dop["prach"][0]) or \
            len(dop["dl"]) != len(cdop["dl"]):
        raise AssertionError("46 doppler_campaign: rows differ in keys")
    _keys_hold("turbo_roofline", committed["turbo_roofline"],
               got["turbo_roofline"]["turbo_roofline"], ROOFLINE_TPU_KEYS)
    scale = got["scale_campaign"]["scale_campaign"]
    _keys_hold("scale_campaign", committed["scale_campaign"], scale)
    if not set(committed["scale_campaign"]["rows"][0]) <= set(
            scale["rows"][0]) or [r["n_dev"] for r in scale["rows"]] != [
            1, 2, 4]:
        raise AssertionError(f"46 scale_campaign rows: {scale['rows']}")
    for prog, tag, ref in (("awgn_campaign", "mcs10", "awgn_results/mcs10"),
                           ("ulsim_campaign", "awgn10",
                            "ulsim_results/awgn10")):
        if _header(f"{out}/{prog}/{tag}.csv") != _header(f"{ref}.csv"):
            raise AssertionError(f"46 {prog}: CSV header")

    # resume: a second run of each finds every configuration's file
    for prog, mod, argv, names in runs:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            mod.main(argv + ["--out-dir", f"{out}/{dirs.get(prog, prog)}"])
        skipped = [name for name in names
                   if f"{name}: exists, skipping" in text.getvalue()]
        if skipped != names:
            raise AssertionError(f"46 {prog}: resumed {skipped} of {names}")
    print("46 resume: a second run of each program skipped every "
          "configuration", flush=True)
    if launch_shapes() != launched:
        raise AssertionError("46: a resumed run launched a kernel")
    shutil.rmtree(out, ignore_errors=True)
    return {"launched": launched,
            "held": _hold_each(launched, held_keys, "46 campaigns", dev, gen,
                               timings)}


def capstone_tti_steps(cap_sim, pf_sim) -> list:
    """Phase 16's (label, fn) of one 100 PRB capstone DL PHY TTI (the
    dedicated 1A subframe: transmit, the UE's noise, the blind receive
    with the SI-RNTI and the C-RNTI searches) and of one multi-UE TTI (the
    broadcast wave and the four UEs' receivers)."""
    dl = cap_sim.dl
    crnti = cap_sim.ue.crnti
    pdu = bytes(range(64))

    def capstone_dl():
        rgrid = dl.transmit(2, ("ded", crnti, pdu))
        return dl.receive(rgrid, 2, [SI_RNTI], crnti)

    def multiue_tti():
        wave = pf_sim.dl.transmit_clean(2, ("ded", pf_sim.ues[0].crnti, pdu))
        for i, ue in enumerate(pf_sim.ues):
            rgrid = pf_sim.dl.ue_demod(wave, pf_sim.ue_rng[i],
                                       n0=pf_sim.ue_n0[i])
            pf_sim.dl.receive(rgrid, 2, [SI_RNTI], ue.crnti)

    if capstone_dl()["pdsch"] is None:
        raise AssertionError("capstone DL TTI lost its PDSCH")
    return [("capstone 100 PRB DL PHY TTI", capstone_dl),
            ("multi-UE 100 PRB TTI, 4 UEs", multiue_tti)]


def _phase(n: int, title: str, fn, *args):
    """Run one phase, with its number, title and seconds printed."""
    print(f"== phase {n}: {title}", flush=True)
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"== phase {n} done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's check needs one")
    dev = "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    kernels.load()
    info = kernels.build_info
    print(f"built {', '.join(kernels.SOURCES)} from openair4g_tpu_torch/csrc "
          f"with nvcc {info['flags']} in {info['seconds']:.1f} s -> "
          f"{info['path']}", flush=True)
    name = None
    for line in info["ptxas"].splitlines():
        m = re.search(r"(turbo_half_iter_kernel|turbo_half_iter_v1_kernel|"
                      r"mrc_llr_kernel|demap_llr_kernel)I((?:Li\d+E)+)", line)
        if m:
            name = f"{m[1]}<{','.join(re.findall(r'Li(\d+)E', m[2]))}>"
        elif ("registers" in line or "spill" in line) and name:
            print(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    timings = []          # device times, taken in phase 16
    torch.cuda.reset_peak_memory_stats()
    turbo = _phase(3, "turbo v2 kernel", check_turbo, dev, gen, timings)
    mrc = _phase(3, "mrc_llr kernel", check_mrc, dev, gen, timings)
    print(f"phase 3 peak device memory {torch.cuda.max_memory_allocated()} "
          "bytes (the plain versions' included)", flush=True)
    _phase(4, "small input, card against CPU", check_small_input, dev)
    counts, flagship_steps = _phase(5, "flagship", flagship, dev)
    demap = _phase(6, "demap_llr kernel", check_demap, dev, gen, timings)
    turbo_v1, n_v1, v1_call = _phase(7, "turbo v1 kernel", check_turbo_v1,
                                     dev, gen, timings)
    _phase(8, "small multi-antenna inputs", check_small_mimo, dev)
    n_demap = _phase(9, "TM2 anchor", tm2_anchor, dev) \
        + _phase(10, "TM3 full width", tm3_full_width, dev)
    mrc.update(_phase(11, "mrc_llr at A = 2", check_mrc_a2, dev, gen,
                      timings))
    _phase(12, "small SISO inputs, card against CPU", check_small_siso, dev)
    dd, dd_sim = _phase(13, "dd 1x2 HARQ full width", dd_full_width, dev)
    _phase(14, "SISO fidelity anchors", fidelity_anchors, dev)
    n_awgn_turbo = _phase(15, "DlsimAwgn and the dlsim command line",
                          entry_point, dev)
    turbo_ul = _phase(17, "turbo v2 kernel at the uplink shape",
                      check_turbo_uplink, dev, gen, timings)
    n_ul = _phase(18, "small uplink inputs, card against CPU",
                  check_small_uplink, dev)
    n_full, ul_per_step, ul_sim = _phase(19, "uplink full width",
                                         uplink_full_width, dev)
    n_ul += n_full + _phase(20, "uplink anchors", uplink_anchors, dev)
    _phase(21, "pucchsim", pucch_points, dev)
    n_mb = _phase(22, "small control and sync inputs, card against CPU",
                  check_small_control, dev)
    turbo_mb = _phase(23, "turbo v2 kernel at the MBSFN shape",
                      check_turbo_mbsfn, dev, gen, timings)
    n_full_mb, mb_per_step, mb_sim = _phase(24, "Mbmssim full width",
                                            mbms_full_width, dev)
    n_mb += n_full_mb + _phase(25, "control and sync anchors",
                               control_anchors, dev)
    steps_20mhz = _phase(26, "sync and PRACH at 20 MHz", sync_prach_20mhz,
                         dev)
    _phase(27, "small per-TTI inputs, card against CPU", check_small_per_tti,
           dev)
    held = _phase(28, "mrc_llr and v2 at the per-TTI shapes",
                  check_kernels_per_tti, dev, gen, timings)
    tti, per_step_29, full_sim = _phase(
        29, "FullChainSim full width, the flagship load", fullsim_full_width,
        dev)
    tti = {29: tti}             # launches by phase, then by (kernel, shape)
    tti[30], per_step_30 = _phase(
        30, "FullChainSim defaults, cold start, fullsim_main, framegen",
        fullsim_defaults_and_entry_points, dev)
    tti[31], per_step_31 = _phase(31, "UlGrantSim and TddFrameSim full width",
                                  closed_loops_full_width, dev)
    tti[32] = _phase(32, "per-TTI reference anchors", per_tti_anchors, dev)
    tti_per_step = {**per_step_31, **per_step_30, **per_step_29}
    held += _phase(33, "every other shape the full-width paths launched",
                   check_kernels_launched, dev, gen, timings,
                   _sum_shapes(tti[29], tti[30], tti[31]), held,
                   {k: what for k, (_, what) in tti_per_step.items()})
    _phase(34, "small oaisim inputs, card against CPU", check_small_oaisim,
           dev)
    turbo_oai = _phase(35, "turbo v2 kernel at the full-PHY oaisim shape",
                       check_turbo_oaisim, dev, gen, timings)
    oai_shapes, oai_per_tti, oai_sim = _phase(
        36, "full-PHY oaisim full width", oaisim_full_phy, dev)
    oai_frames = [("oaisim full PHY full width", oai_sim)] + _phase(
        37, "abstraction oaisim full width", oaisim_abstraction_full, dev)
    _phase(38, "oaisim anchors, full stack, AES", oaisim_anchors, dev)
    cap = {39: _phase(39, "small capstone, card against CPU",
                      check_small_capstone, dev)}
    cap[40], cap_sim = _phase(40, "capstone full width", capstone_full_width,
                              dev)
    cap[41], pf_sim = _phase(41, "multi-UE capstones and handover full width",
                             multiue_full_width, dev)
    held_cap = _phase(41, "v2 at every shape the capstones launched",
                      check_kernels_capstone, dev, gen, timings,
                      _sum_shapes(*cap.values()))
    modem = _phase(43, "the runtime at 20 MHz", runtime_20mhz, dev)
    # every (kernel, shape) a row of the kernels line holds so far
    held_keys = PHASE3_KEYS | {(name, key) for name, key, _ in
                               held + held_cap} | set(EARLIER_V2_KEYS)
    par = _phase(44, "parallel on the card", parallel_on_card, dev, gen,
                 timings, held_keys)
    ported = _phase(45, "the port bench", port_bench, dev, gen, timings,
                    held_keys)
    camp = _phase(46, "the campaign programs", campaigns, dev, gen, timings,
                  held_keys)
    obs = _phase(42, "observability on the flagship", observability_flagship,
                 dev)
    cap_steps = capstone_tti_steps(cap_sim, pf_sim)
    ul_dev, mb_dev, full_dev, oai_dev, step_dev = _phase(
        16, "device time of each kernel (run last)", device_times, timings,
        v1_call, dd_sim, ul_sim, mb_sim,
        steps_20mhz + cap_steps + ported["steps"], full_sim,
        oai_frames, [label for label, _ in cap_steps])

    per_step = {k: v / flagship_steps for k, v in counts.items()}
    rows = [
        dict(name="turbo_half_iter", route="cuda",
             source="openair4g_tpu_torch/csrc/turbo_half_iter.cu",
             replaces="openair4g_tpu/ops/turbo_pallas.py:219",
             launches=counts["turbo_half_iter"] + dd["turbo_half_iter"]
             + n_awgn_turbo, launches_per_step=per_step["turbo_half_iter"],
             **turbo),
        dict(name="turbo_half_iter_v1", route="cuda",
             source="openair4g_tpu_torch/csrc/turbo_half_iter.cu",
             replaces="openair4g_tpu/ops/turbo_pallas.py:70",
             launches=n_v1, launches_per_step=per_step["turbo_half_iter_v1"],
             **turbo_v1),
        dict(name="mrc_llr", route="cuda",
             source="openair4g_tpu_torch/csrc/mrc_llr.cu",
             replaces="openair4g_tpu/ops/equalize_llr.py:40",
             launches=counts["mrc_llr"] + dd["mrc_llr"],
             launches_per_step=per_step["mrc_llr"], **mrc),
        dict(name="demap_llr", route="cuda",
             source="openair4g_tpu_torch/csrc/mrc_llr.cu",
             replaces="openair4g_tpu/ops/equalize_llr.py:138",
             launches=n_demap, launches_per_step=per_step["demap_llr"],
             **demap),
        dict(name="turbo_half_iter", shape="uplink 1,024 x 5,760",
             route="cuda",
             source="openair4g_tpu_torch/csrc/turbo_half_iter.cu",
             replaces="openair4g_tpu/ops/turbo_pallas.py:219",
             launches=n_ul, launches_per_step=ul_per_step,
             uplink_step_device_ms=ul_dev["step_device_ms"],
             uplink_kernel_share=ul_dev["kernel_share"], **turbo_ul),
        dict(name="turbo_half_iter", shape="MBSFN 1,024 x 6,000",
             route="cuda",
             source="openair4g_tpu_torch/csrc/turbo_half_iter.cu",
             replaces="openair4g_tpu/ops/turbo_pallas.py:219",
             launches=n_mb, launches_per_step=mb_per_step,
             mbms_step_device_ms=mb_dev["step_device_ms"],
             mbms_kernel_share=mb_dev["kernel_share"], **turbo_mb),
    ]
    # This slice's rows: one a (kernel, shape) held in phase 28 or 33, with
    # the launches of that shape alone, by phase, and a step of the first
    # run where it ran; the flagship load's v2 row with its step's device
    # time and v2's share of it.
    sources = {"turbo_half_iter": ("turbo_half_iter.cu",
                                   "turbo_pallas.py:219"),
               "mrc_llr": ("mrc_llr.cu", "equalize_llr.py:40"),
               "demap_llr": ("mrc_llr.cu", "equalize_llr.py:138")}
    # the first row of each (kernel, shape): later phases' launches go to it
    row_of = {key: rows[0 if key[0] == "turbo_half_iter" else 2]
              for key in PHASE3_KEYS}
    row_of.update(zip(EARLIER_V2_KEYS[:2], rows[4:6]))
    for name, key, row in held:
        by_phase = {n: c[name, key] for n, c in tti.items()
                    if (name, key) in c}
        extra = {}
        if (name, key) in tti_per_step:
            extra["launches_per_step"], extra["step_of"] = \
                tti_per_step[name, key]
        if name == "turbo_half_iter" and (name, key) in per_step_29:
            extra.update(fullsim_step_device_ms=full_dev["step_device_ms"],
                         fullsim_kernel_device_ms_per_step=full_dev[
                             "kernel_device_ms_per_step"],
                         fullsim_kernel_share=full_dev["kernel_share"])
        src, tpu = sources[name]
        rows.append(dict(
            name=name, route="cuda", source=f"openair4g_tpu_torch/csrc/{src}",
            replaces=f"openair4g_tpu/ops/{tpu}",
            launches=sum(by_phase.values()), launches_by_phase=by_phase,
            **extra, **row, share=row["bound_ms"] / row["device_ms"]))
        row_of.setdefault((name, key), rows[-1])
    # The system slice's row: v2 at the full-PHY oaisim shape, with phase
    # 36's launches at it, those a TTI, the device time a TTI of phases 36
    # and 37 and v2's share of phase 36's.
    oai, oai_label = oai_dev, oai_frames[0][0]
    rows.append(dict(
        name="turbo_half_iter", route="cuda",
        source="openair4g_tpu_torch/csrc/turbo_half_iter.cu",
        replaces="openair4g_tpu/ops/turbo_pallas.py:219",
        launches=oai_shapes[("turbo_half_iter", (OAISIM_ROWS, OAISIM_N,
                                                 TURBO_W, TURBO_U))],
        launches_per_tti=oai_per_tti,
        oaisim_tti_device_ms=oai[oai_label]["tti_device_ms"],
        oaisim_kernel_device_ms_per_tti=oai[oai_label][
            "kernel_device_ms_per_tti"],
        oaisim_kernel_share=oai[oai_label]["kernel_share"],
        oaisim_abstraction_tti_device_ms={
            label: oai[label]["tti_device_ms"] for label, _ in oai_frames[1:]},
        **turbo_oai, share=turbo_oai["bound_ms"] / turbo_oai["device_ms"]))
    row_of[EARLIER_V2_KEYS[2]] = rows[-1]
    # The capstone slice's rows: v2 at each shape the capstones launched,
    # with its launches by phase (39-41), the device time of a 100 PRB
    # capstone DL PHY TTI and a 4-UE multi-UE TTI, the SoftModem's
    # deadline count and the flagship step with the profiler on and off.
    extra = {"capstone_dl_tti_device_ms": step_dev[cap_steps[0][0]][
                 "device_ms"],
             "multiue_tti_device_ms": step_dev[cap_steps[1][0]]["device_ms"],
             "softmodem_missed": modem["missed"],
             "flagship_step_profiler_on_ms": obs["profiler_on_ms"],
             "flagship_step_profiler_off_ms": obs["profiler_off_ms"]}
    for name, key, row in held_cap:
        by_phase = {n: c[name, key] for n, c in cap.items() if (name, key) in c}
        rows.append(dict(
            name=name, route="cuda",
            source="openair4g_tpu_torch/csrc/turbo_half_iter.cu",
            replaces="openair4g_tpu/ops/turbo_pallas.py:219",
            launches=sum(by_phase.values()), launches_by_phase=by_phase,
            **extra, **row, share=row["bound_ms"] / row["device_ms"]))
        row_of.setdefault((name, key), rows[-1])
    # The bench's row: v2 at the turbo cell's shape, with its launches a
    # decode call and the two decodes' device time. Then the rows of each
    # (kernel, shape) that the ranks of phase 44, the bench (45) and the
    # campaigns (46) launched and held, with those launches; their
    # launches at a shape an earlier row holds go to that row.
    by_step = {label: step_dev[label]["device_ms"]
               for label, _ in ported["steps"]}
    turbo_cell = ported["cells"]["turbo"]
    n = ported["launched"]["turbo_half_iter", BENCH_TURBO]
    rows.append(dict(
        name="turbo_half_iter", route="cuda",
        source="openair4g_tpu_torch/csrc/turbo_half_iter.cu",
        replaces="openair4g_tpu/ops/turbo_pallas.py:219", launches=n,
        launches_by_phase={45: n},
        launches_per_decode=turbo_cell["launches"],
        decode_device_ms={mode: by_step[f"bench turbo {mode}"]
                          for mode in turbo_cell["value"]},
        **ported["turbo_row"],
        share=ported["turbo_row"]["bound_ms"]
        / ported["turbo_row"]["device_ms"]))
    row_of["turbo_half_iter", BENCH_TURBO] = rows[-1]
    for phase, res in ((44, par), (45, ported), (46, camp)):
        own = {("turbo_half_iter", BENCH_TURBO)} if phase == 45 else set()
        for name, key, row in res["held"]:
            src, tpu = sources[name]
            n = res["launched"][name, key]
            rows.append(dict(
                name=name, route="cuda",
                source=f"openair4g_tpu_torch/csrc/{src}",
                replaces=f"openair4g_tpu/ops/{tpu}", launches=n,
                launches_by_phase={phase: n}, **row,
                share=row["bound_ms"] / row["device_ms"]))
            row_of[name, key] = rows[-1]
            own.add((name, key))
        for key, n in res["launched"].items():
            if key not in own:
                row = row_of[key]
                row["launches"] += n
                by_phase = row.setdefault("launches_by_phase", {})
                by_phase[phase] = by_phase.get(phase, 0) + n
    rows[0]["shape"] = "flagship 1,408 x 5,760"
    for row in rows:        # no one PyTorch call computes any of these
        row["library_ms"] = None
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
