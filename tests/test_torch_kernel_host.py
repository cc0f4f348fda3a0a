"""Host C++ check of the ``biquad_cascade`` and ``deesser_scan`` CUDA sources.

The kernels keep each lane's step in ``AFK_HD`` functions (``csrc/afk.cuh``)
with the ``__global__`` parts under ``__CUDACC__``, so ``g++ -x c++`` builds
the same arithmetic for the host. The small ``extern "C"`` runner below runs
each stream's lanes in the kernel's schedule: T chunked as the tile is, at
wavefront step k section (or dynamic band) s filters sample t = k - s with
the previous step's output of lane s - 1 as its input, the last lane writes
over the tile, and the de-esser calls the kernel's own phase functions
(serial: one lane per band over the chunk; parallel: one sample) in the
kernel's order over a tile of the kernel's layout. Only the warp shuffles and
the thread indexing are the runner's own. The tests hold it
against the plain PyTorch twins at
N = 3, T = 480, once with the whole block as one chunk and once in chunks of
128 samples (the crossfade weight then depends on the chunk's offset).
Tolerances: ``biquad_cascade`` y and z 1e-6 (both f64 inside);
``deesser_scan`` y 1e-4 and state 1e-3 (f32 libm against torch's
``log10``/``pow``). Needs ``g++``; without it the tests skip with a reason.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from audioforge_tpu_torch.ops import biquad as tbq
from audioforge_tpu_torch.ops import deesser as tdes

N, T, FS = 3, 480, 48000.0
CHUNKS = [T, 128]
CSRC = Path(tbq.__file__).resolve().parents[1] / "csrc"

RUNNER = r"""
#include <algorithm>
#include <vector>
#include "biquad_cascade.cu"
#include "deesser_scan.cu"

extern "C" int host_biquad_cascade(const float* x, const float* coeffs,
                                   const double* z_in, const int* fade_total,
                                   const int* fade_remaining, float* y,
                                   double* z_out, int N, int S, int T, int tc_max) {
    if (S < 1 || S > AFK_BIQUAD_MAX_SECTIONS || tc_max < 1) return 1;
    std::vector<float> row(std::max(T, 1));
    for (int n = 0; n < N; ++n) {
        BiquadLane L[AFK_BIQUAD_MAX_SECTIONS];
        double v[AFK_BIQUAD_MAX_SECTIONS] = {};
        for (int s = 0; s < S; ++s) {
            const long long sec = (long long)n * S + s;
            bq_lane_load(L[s], coeffs + sec * 10, z_in + sec * 4, fade_total[sec],
                         fade_remaining[sec]);
        }
        // as the kernel's warp vote: the pending lanes run where any fades
        bool fade = false;
        for (int s = 0; s < S; ++s) fade = fade || L[s].fading;
        for (int c0 = 0; c0 < T; c0 += tc_max) {
            const int tc = std::min(tc_max, T - c0);
            std::copy(x + (long long)n * T + c0, x + (long long)n * T + c0 + tc,
                      row.begin());
            for (int kb = 0; kb < tc + S - 1; kb += BQ_GROUP) {
                double w[AFK_BIQUAD_MAX_SECTIONS][BQ_GROUP] = {};
                for (int s = 0; s < S && fade; ++s) bq_group_weights(L[s], kb, s, c0, w[s]);
                for (int k = kb; k < kb + BQ_GROUP; ++k) {
                    // as __shfl_up_sync: lane s takes lane s-1's output of step k-1
                    double in[AFK_BIQUAD_MAX_SECTIONS];
                    in[0] = k < tc ? row[k] : 0.0;
                    for (int s = 1; s < S; ++s) in[s] = v[s - 1];
                    const bool check = !bq_group_steady(kb, S, tc);
                    for (int s = 0; s < S; ++s) {
                        auto* step = fade ? (check ? bq_wave_step<true, true>
                                                   : bq_wave_step<true, false>)
                                          : (check ? bq_wave_step<false, true>
                                                   : bq_wave_step<false, false>);
                        step(L[s], v[s], in[s], w[s][k - kb], k, s, S, true, tc, row.data());
                    }
                }
            }
            std::copy(row.begin(), row.begin() + tc, y + (long long)n * T + c0);
        }
        for (int s = 0; s < S; ++s)
            bq_lane_store(L[s], z_out + ((long long)n * S + s) * 4);
    }
    return 0;
}

// One thread block's work: the phases in the kernel's order over the same
// tile rows, each lane (serial phases) or sample (parallel phases) in turn.
template <bool AUTO>
static void host_deesser(const float* x, const float* s_in, float* y, float* s_out,
                         int N, int T, int tc_max, const DeesserConsts& k) {
    const int stride = std::max(tc_max, 1);
    std::vector<float> tile(DR_ROWS * DS_STREAMS * stride);
    float* tl = tile.data();
    for (int n0 = 0; n0 < N; n0 += DS_STREAMS) {
        const int rows = std::min(DS_STREAMS, N - n0);
        DsLane L[DS_STREAMS][DS_LANES];
        for (int g = 0; g < rows; ++g)
            for (int l = 0; l < DS_LANES; ++l) ds_lane_load(L[g][l], l, s_in + n0 + g, N, k);
        for (int c0 = 0; c0 < T; c0 += tc_max) {
            const int tc = std::min(tc_max, T - c0);
            for (int g = 0; g < rows; ++g)
                std::copy(x + (long long)(n0 + g) * T + c0,
                          x + (long long)(n0 + g) * T + c0 + tc, ds_row(tl, stride, DR_X, g));
            for (int g = 0; g < rows; ++g)  // A
                for (int l = 0; l < DS_LANES; ++l) ds_phase_detect(L[g][l], l, tl, stride, g, tc, k);
            for (int g = 0; g < rows; ++g)  // B
                for (int t = 0; t < tc; ++t) ds_sample_inputs<AUTO>(tl, stride, g, t);
            for (int g = 0; g < rows; ++g)  // C
                for (int b = 0; b < DS_BANDS; ++b)
                    ds_phase_recur<AUTO>(L[g][b], b, tl, stride, g, tc, k);
            for (int g = 0; g < rows; ++g)  // D
                for (int t = 0; t < tc; ++t) ds_sample_targets<AUTO>(tl, stride, g, t, k);
            for (int g = 0; g < rows; ++g)  // E
                for (int b = 0; b < DS_BANDS; ++b) ds_phase_reduce(L[g][b], b, tl, stride, g, tc, k);
            for (int b = 0; b < DS_BANDS; ++b)  // F
                for (int g = 0; g < rows; ++g)
                    for (int t = 0; t < tc; ++t) ds_sample_coeffs(tl, stride, b, g, t, k);
            for (int g = 0; g < rows; ++g) {  // G: the dynamic bands as a wavefront
                float* row = ds_row(tl, stride, DR_X, g);
                float v[DS_LANES] = {};
                for (int kk = 0; kk < tc + DS_BANDS - 1; ++kk) {
                    // as __shfl_up_sync: band b takes band b-1's output of step kk-1
                    const float in[DS_LANES] = {kk < tc ? row[kk] : 0.0f, v[0], v[1], v[2]};
                    for (int l = 0; l < DS_LANES; ++l) {
                        float c[5];
                        ds_coeffs_at(tl, stride, std::min(l, DS_BANDS - 1), g,
                                     std::max(0, std::min(kk - l, tc - 1)), c);
                        ds_dyn_wave_step(L[g][l], v[l], in[l], c, kk, l, tc, row);
                    }
                }
                std::copy(row, row + tc, y + (long long)(n0 + g) * T + c0);
            }
        }
        for (int g = 0; g < rows; ++g) {
            DsLane* Lg = L[g];
            if (T > 0) {
                Lg[DS_BANDS].red = ds_total_reduction(Lg[0].red, Lg[1].red, Lg[2].red, k);
                Lg[DS_BANDS].conf = ds_detector_confidence(Lg[0].conf, Lg[1].conf, Lg[2].conf);
            }
            for (int l = 0; l < DS_LANES; ++l) ds_lane_store(Lg[l], l, s_out + n0 + g, N);
        }
    }
}

// Weights n / d for which bq_quotient and the division differ, over every
// integer d in [1, max_d] and n in [1, d + extra].
extern "C" long long host_quotient_mismatches(int max_d, int extra) {
    long long bad = 0;
    for (int d = 1; d <= max_d; ++d) {
        const double dd = d, rcp = 1.0 / dd;
        for (int n = 1; n <= d + extra; ++n)
            bad += bq_quotient((double)n, dd, rcp) != (double)n / dd;
    }
    return bad;
}

extern "C" int host_deesser_scan(const float* x, const float* s_in, float* y,
                                 float* s_out, int N, int T, const float* consts,
                                 int n_consts, int auto_mode, int tc_max) {
    if (n_consts != DS_CONSTS || tc_max < 1) return 1;
    DeesserConsts k;
    std::memcpy(&k, consts, sizeof(k));
    if (auto_mode)
        host_deesser<true>(x, s_in, y, s_out, N, T, tc_max, k);
    else
        host_deesser<false>(x, s_in, y, s_out, N, T, tc_max, k);
    return 0;
}
"""

_P, _I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The two kernel sources built for the host behind the runner."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of the CUDA sources needs it")
    tmp = tmp_path_factory.mktemp("kernel_host")
    src = tmp / "runner.cpp"
    src.write_text(RUNNER)
    lib_path = tmp / "libafk_host.so"
    cmd = [gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
           "-ffp-contract=off", "-I", str(CSRC), "-o", str(lib_path), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    assert proc.returncode == 0, f"{' '.join(cmd)}\n{proc.stderr}"
    lib = ctypes.CDLL(str(lib_path))
    lib.host_biquad_cascade.argtypes = (_P,) * 7 + (_I,) * 4
    lib.host_biquad_cascade.restype = _I
    lib.host_deesser_scan.argtypes = (_P,) * 4 + (_I, _I, _P, _I, _I, _I)
    lib.host_deesser_scan.restype = _I
    lib.host_quotient_mismatches.argtypes = (_I, _I)
    lib.host_quotient_mismatches.restype = ctypes.c_longlong
    return lib


def _ptr(a: np.ndarray) -> int:
    assert a.flags.c_contiguous
    return a.ctypes.data


def _cascade_inputs(S: int, seed: int):
    """A block and a cascade of S sections per stream: stream 0 has every
    section's crossfade ending mid-block (at t = 40), stream 1 is idle,
    stream 2 fades on even sections past the block's end."""
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((N, T))).astype(np.float32)
    freqs = np.geomspace(60.0, 12000.0, S)
    kinds = [tbq.HIGH_PASS if S <= 2 and s == 0 else tbq.PEAKING for s in range(S)]
    old = np.stack([tbq.design(k, f, g, 2.0, FS) for k, f, g
                    in zip(kinds, freqs, rng.uniform(-4, 4, S))])
    new = np.stack([tbq.design(k, f * 1.2, g, 1.5, FS) for k, f, g
                    in zip(kinds, freqs, rng.uniform(-4, 4, S))])
    coeffs = np.empty((N, S, 2, 5), np.float32)
    coeffs[:, :, 0] = old
    coeffs[:, :, 1] = new
    z = (0.05 * rng.standard_normal((N, S, 2, 2))).astype(np.float64)
    total = np.zeros((N, S), np.int32)
    remaining = np.zeros((N, S), np.int32)
    total[0], remaining[0] = 72, 40
    total[2, ::2], remaining[2, ::2] = 700, 650
    idle = remaining == 0
    coeffs[idle, 1] = coeffs[idle, 0]  # idle lanes are identical
    z[idle, 1] = z[idle, 0]
    return x, coeffs, z, total, remaining


@pytest.mark.parametrize("tc", CHUNKS, ids=lambda c: f"chunk{c}")
@pytest.mark.parametrize("S", [1, 2, 10])
def test_biquad_cascade_host_build_matches_plain(host_lib, S, tc):
    x, coeffs, z, total, remaining = _cascade_inputs(S, seed=40 + S)
    y = np.empty_like(x)
    z_out = np.empty_like(z)
    err = host_lib.host_biquad_cascade(
        _ptr(x), _ptr(coeffs), _ptr(z), _ptr(total), _ptr(remaining), _ptr(y),
        _ptr(z_out), N, S, T, tc)
    assert err == 0
    yp, zp = tbq.biquad_cascade_plain(*(torch.from_numpy(a) for a in
                                        (x, coeffs, z, total, remaining)))
    np.testing.assert_allclose(y, yp.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(z_out, zp.numpy(), rtol=0, atol=1e-6)
    if S > 1:  # the crossfade changed stream 0's output against idle lanes
        idle = dict(zip(("x", "coeffs", "z", "total", "remaining"),
                        (torch.from_numpy(a) for a in (x, coeffs, z, total, remaining))))
        idle["remaining"] = torch.zeros_like(idle["remaining"])
        y_idle, _ = tbq.biquad_cascade_plain(*idle.values())
        assert np.abs(y[0] - y_idle[0].numpy()).max() > 1e-3


def test_crossfade_weight_equals_the_division(host_lib):
    """The kernel's crossfade weight (reciprocal and FMA correction) is the
    correctly rounded quotient the plain twin's division gives, bit for bit,
    for every crossfade length a unit schedules and 4096 samples past it."""
    longest = tbq.MAX_COEFF_CROSSFADE_SAMPLES
    assert host_lib.host_quotient_mismatches(longest, 4096) == 0


def _sibilant(n_blocks: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * T) / FS
    body = 0.05 * np.sin(2 * np.pi * rng.uniform(120.0, 220.0, (N, 1)) * t)
    sib = 0.25 * np.sin(2 * np.pi * 6800.0 * t) * (
        np.sin(2 * np.pi * rng.uniform(3.0, 6.0, (N, 1)) * t) > -0.5)
    x = body + sib + 0.002 * rng.standard_normal((N, t.size))
    x[2] = body[2]  # one stream without sibilance
    return x.astype(np.float32)


@pytest.mark.parametrize("tc", CHUNKS, ids=lambda c: f"chunk{c}")
@pytest.mark.parametrize("auto", [True, False], ids=["auto", "manual"])
def test_deesser_scan_host_build_matches_plain(host_lib, auto, tc):
    cfg = tdes.DeEsserConfig(enabled=True, auto_enabled=auto, threshold_db=-40.0)
    x = _sibilant(3, seed=80 + auto)
    state = tdes.deesser_init(cfg, n=N, device="cpu")
    for b in range(2):  # warm the envelopes so the reduction is engaged
        state, _ = tdes.deesser_scan_plain(cfg, state, torch.from_numpy(x[:, b * T:(b + 1) * T]))
    xb = np.ascontiguousarray(x[:, 2 * T:])
    s_in = tdes.pack_scan_state(state).numpy()
    consts = tdes._consts(cfg)
    y = np.empty_like(xb)
    s_out = np.empty_like(s_in)
    err = host_lib.host_deesser_scan(_ptr(xb), _ptr(s_in), _ptr(y), _ptr(s_out), N, T,
                                     _ptr(consts), consts.size, int(auto), tc)
    assert err == 0
    sp, yp = tdes.deesser_scan_plain(cfg, state, torch.from_numpy(xb))
    np.testing.assert_allclose(y, yp.numpy(), rtol=0, atol=1e-4)
    sk = tdes.unpack_scan_state(torch.from_numpy(s_out), state)
    for key, ref in sp.items():
        np.testing.assert_allclose(sk[key].numpy(), ref.numpy(), rtol=0, atol=1e-3,
                                   err_msg=key)
    red = sp["current_reduction_db"].numpy()
    assert red[:2].min() > 0.1 and red[2] < red[:2].min()  # sibilance engaged it
