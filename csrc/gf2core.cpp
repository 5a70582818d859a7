// gf2core — native host-side runtime: bit-packed GF(2) linear algebra and a
// reference-semantics CPU min-sum decoder.
//
// Role in the framework (the accelerator does the hot Monte-Carlo path; this is the
// native host runtime around it):
//   * word-parallel GF(2) elimination used by preprocessing (rank/RREF/
//     nullspace of parity-check matrices, logical-operator extraction) —
//     replaces the reference's per-element Python loops (qLDPCsim/gf2math.py)
//     at native speed for large codes;
//   * a batched CPU min-sum decoder with the exact reference update rules
//     (qLDPCsim/decoders.py:110-182 semantics: beta-normalized, min/min2 with
//     value-equality ties, layered CN + global VN update, per-layer early
//     exit) used for host-side validation of qBLER curves at scale and as the
//     measured "reference CPU simulator" class baseline.
//
// C ABI only; bound from Python via ctypes (qldpcsim_jax/gf2/native.py).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <thread>

extern "C" {

// ---------------------------------------------------------------------------
// Bit-packed GF(2) elimination. Rows are ceil(n/64) uint64 words, LSB-first.
// Returns rank; fills pivots[] (size >= min(m,n)) with pivot column indices.
// If T != nullptr it must be an m x twords identity and receives the row ops
// (so R_out = T * R_in over GF(2)). reduced != 0 => RREF, else REF.
// ---------------------------------------------------------------------------
int gf2_eliminate(uint64_t* R, int m, int n, int words,
                  uint64_t* T, int twords, int reduced, int* pivots) {
    int row = 0;
    int rank = 0;
    for (int col = 0; col < n && row < m; ++col) {
        const int w = col >> 6;
        const uint64_t mask = 1ULL << (col & 63);
        int piv = -1;
        for (int r = row; r < m; ++r) {
            if (R[(size_t)r * words + w] & mask) { piv = r; break; }
        }
        if (piv < 0) continue;
        if (piv != row) {
            for (int k = 0; k < words; ++k)
                std::swap(R[(size_t)piv * words + k], R[(size_t)row * words + k]);
            if (T) for (int k = 0; k < twords; ++k)
                std::swap(T[(size_t)piv * twords + k], T[(size_t)row * twords + k]);
        }
        const uint64_t* src = &R[(size_t)row * words];
        const uint64_t* tsrc = T ? &T[(size_t)row * twords] : nullptr;
        const int r0 = reduced ? 0 : row + 1;
        for (int r = r0; r < m; ++r) {
            if (r == row) continue;
            if (R[(size_t)r * words + w] & mask) {
                uint64_t* dst = &R[(size_t)r * words];
                for (int k = 0; k < words; ++k) dst[k] ^= src[k];
                if (T) {
                    uint64_t* tdst = &T[(size_t)r * twords];
                    for (int k = 0; k < twords; ++k) tdst[k] ^= tsrc[k];
                }
            }
        }
        if (pivots) pivots[rank] = col;
        ++row;
        ++rank;
    }
    return rank;
}

int gf2_rank(const uint64_t* rows, int m, int n, int words) {
    std::vector<uint64_t> R(rows, rows + (size_t)m * words);
    return gf2_eliminate(R.data(), m, n, words, nullptr, 0, 0, nullptr);
}

// ---------------------------------------------------------------------------
// Batched CPU min-sum decoder, reference semantics (decoders.py:110-182).
// H: m*n int8 row-major. syndromes: B*m int8. layers: contiguous ranges
// [starts[l], ends[l]). Outputs e_out (B*n int8), iters_out (B int32),
// conv_out (B int8). Returns 0.
// ---------------------------------------------------------------------------
int ms_decode_cpu(const int8_t* H, int m, int n,
                  const int8_t* syndromes, int B,
                  float p, int max_iter, float beta,
                  const int32_t* starts, const int32_t* ends, int n_layers,
                  int8_t* e_out, int32_t* iters_out, int8_t* conv_out,
                  float* post_out) {
    // CSR-style row adjacency.
    std::vector<int> row_ptr(m + 1, 0);
    for (int i = 0; i < m; ++i) {
        int cnt = 0;
        for (int j = 0; j < n; ++j) cnt += H[(size_t)i * n + j] != 0;
        row_ptr[i + 1] = row_ptr[i] + cnt;
    }
    const int E = row_ptr[m];
    std::vector<int> cols(E);
    for (int i = 0, e = 0; i < m; ++i)
        for (int j = 0; j < n; ++j)
            if (H[(size_t)i * n + j]) cols[e++] = j;

    const float eps = 1e-9f;
    const float L_ch = std::log((1.0f - p) / std::max(p, eps));

    std::vector<float> c2v(E), v2c(E), posterior(n);
    std::vector<int8_t> e_hat(n);

    for (int b = 0; b < B; ++b) {
        const int8_t* syn = &syndromes[(size_t)b * m];
        std::fill(c2v.begin(), c2v.end(), 0.0f);
        std::fill(v2c.begin(), v2c.end(), L_ch);
        std::fill(posterior.begin(), posterior.end(), L_ch);
        int used = max_iter;
        bool conv = false;

        for (int it = 0; it < max_iter && !conv; ++it) {
            for (int l = 0; l < n_layers && !conv; ++l) {
                // CN update on layer rows.
                for (int i = starts[l]; i < ends[l]; ++i) {
                    const int e0 = row_ptr[i], e1 = row_ptr[i + 1];
                    if (e0 == e1) continue;
                    float min1 = INFINITY, min2 = INFINITY;
                    int sgn_parity = 0;
                    for (int e = e0; e < e1; ++e) {
                        const float v = v2c[e];
                        const float a = std::fabs(v);
                        if (v < 0.0f) sgn_parity ^= 1;
                        if (a < min1) { min2 = min1; min1 = a; }
                        else if (a < min2) { min2 = a; }
                    }
                    if (!std::isfinite(min2)) min2 = 0.0f;
                    const float ssign = syn[i] ? -1.0f : 1.0f;
                    const float psign = sgn_parity ? -1.0f : 1.0f;
                    for (int e = e0; e < e1; ++e) {
                        const float v = v2c[e];
                        const float a = std::fabs(v);
                        const float s = (v < 0.0f) ? -1.0f : 1.0f; // sign(0)=+1
                        const float mag = (a == min1) ? min2 : min1;
                        c2v[e] = beta * ssign * psign * s * mag;
                    }
                }
                // Global VN update: posterior = L_ch + column sums of c2v.
                std::fill(posterior.begin(), posterior.end(), L_ch);
                for (int i = 0; i < m; ++i)
                    for (int e = row_ptr[i]; e < row_ptr[i + 1]; ++e)
                        posterior[cols[e]] += c2v[e];
                for (int j = 0; j < n; ++j) e_hat[j] = posterior[j] < 0.0f;
                // Early exit: H e_hat == syndrome (mod 2).
                bool ok = true;
                for (int i = 0; i < m && ok; ++i) {
                    int par = 0;
                    for (int e = row_ptr[i]; e < row_ptr[i + 1]; ++e)
                        par ^= e_hat[cols[e]];
                    ok = (par == (syn[i] != 0));
                }
                if (ok) { conv = true; used = it + 1; break; }
                // Global v2c refresh.
                for (int i = 0; i < m; ++i)
                    for (int e = row_ptr[i]; e < row_ptr[i + 1]; ++e)
                        v2c[e] = posterior[cols[e]] - c2v[e];
            }
        }
        std::memcpy(&e_out[(size_t)b * n], e_hat.data(), n);
        iters_out[b] = used;
        conv_out[b] = conv ? 1 : 0;
        if (post_out)
            std::memcpy(&post_out[(size_t)b * n], posterior.data(),
                        n * sizeof(float));
    }
    return 0;
}


// ---------------------------------------------------------------------------
// Batched CPU sum-product (BP) decoder with STRICT reference numerics
// (qLDPCsim/decoders.py:189-290 semantics): float64 messages, eps = 1e-9,
// L0 = log((1-p)/max(p,eps)), tanh-product check update with
// clamp-by-subtraction (|th2| >= 1-eps  =>  th2 -= eps*sign(th2)), layered
// CN update + GLOBAL VN update + per-layer early exit. Used as the
// high-power oracle side of the qBLER parity harness (benchmarks/parity.py).
// post_out (B*n float64) receives the final posterior LLRs (for OSD).
// ---------------------------------------------------------------------------
int bp_decode_cpu(const int8_t* H, int m, int n,
                  const int8_t* syndromes, int B,
                  double p, int max_iter,
                  const int32_t* starts, const int32_t* ends, int n_layers,
                  int8_t* e_out, int32_t* iters_out, int8_t* conv_out,
                  double* post_out) {
    std::vector<int> row_ptr(m + 1, 0);
    for (int i = 0; i < m; ++i) {
        int cnt = 0;
        for (int j = 0; j < n; ++j) cnt += H[(size_t)i * n + j] != 0;
        row_ptr[i + 1] = row_ptr[i] + cnt;
    }
    const int E = row_ptr[m];
    std::vector<int> cols(E);
    for (int i = 0, e = 0; i < m; ++i)
        for (int j = 0; j < n; ++j)
            if (H[(size_t)i * n + j]) cols[e++] = j;

    const double eps = 1e-9;
    const double L0 = std::log((1.0 - p) / std::max(p, eps));

    std::vector<double> c2v(E), v2c(E), posterior(n);
    std::vector<int8_t> e_hat(n);

    for (int b = 0; b < B; ++b) {
        const int8_t* syn = &syndromes[(size_t)b * m];
        std::fill(c2v.begin(), c2v.end(), 0.0);
        std::fill(v2c.begin(), v2c.end(), L0);
        std::fill(posterior.begin(), posterior.end(), L0);
        std::fill(e_hat.begin(), e_hat.end(), 0);
        int used = max_iter;
        bool conv = false;

        for (int it = 0; it < max_iter && !conv; ++it) {
            for (int l = 0; l < n_layers && !conv; ++l) {
                for (int i = starts[l]; i < ends[l]; ++i) {
                    const int e0 = row_ptr[i], e1 = row_ptr[i + 1];
                    if (e0 == e1) continue;
                    double prod = 1.0;  // sequential product, edge order
                    for (int e = e0; e < e1; ++e)
                        prod *= std::tanh(v2c[e] / 2.0);
                    for (int e = e0; e < e1; ++e) {
                        double th2 = prod / std::tanh(v2c[e] / 2.0);
                        if (std::fabs(th2) >= 1.0 - eps) {
                            const double s = (th2 > 0.0) ? 1.0
                                           : (th2 < 0.0 ? -1.0 : 0.0);
                            th2 -= eps * s;  // reference clamp-by-subtraction
                        }
                        double val = 2.0 * std::atanh(th2);
                        if (syn[i]) val = -val;
                        c2v[e] = val;
                    }
                }
                // Global VN update: posterior, hard decision, v2c refresh.
                std::fill(posterior.begin(), posterior.end(), L0);
                for (int i = 0; i < m; ++i)
                    for (int e = row_ptr[i]; e < row_ptr[i + 1]; ++e)
                        posterior[cols[e]] += c2v[e];
                for (int j = 0; j < n; ++j) e_hat[j] = posterior[j] < 0.0;
                for (int i = 0; i < m; ++i)
                    for (int e = row_ptr[i]; e < row_ptr[i + 1]; ++e)
                        v2c[e] = posterior[cols[e]] - c2v[e];
                bool ok = true;
                for (int i = 0; i < m && ok; ++i) {
                    int par = 0;
                    for (int e = row_ptr[i]; e < row_ptr[i + 1]; ++e)
                        par ^= e_hat[cols[e]];
                    ok = (par == (syn[i] != 0));
                }
                if (ok) { conv = true; used = it + 1; }
            }
        }
        std::memcpy(&e_out[(size_t)b * n], e_hat.data(), n);
        iters_out[b] = used;
        conv_out[b] = conv ? 1 : 0;
        if (post_out)
            std::memcpy(&post_out[(size_t)b * n], posterior.data(),
                        n * sizeof(double));
    }
    return 0;
}

int bp_decode_cpu_mt(const int8_t* H, int m, int n,
                     const int8_t* syndromes, int B,
                     double p, int max_iter,
                     const int32_t* starts, const int32_t* ends, int n_layers,
                     int8_t* e_out, int32_t* iters_out, int8_t* conv_out,
                     double* post_out, int threads) {
    int T = threads > 0 ? threads
                        : (int)std::thread::hardware_concurrency();
    if (T < 1) T = 1;
    if (T > B) T = B;
    if (T == 1)
        return bp_decode_cpu(H, m, n, syndromes, B, p, max_iter,
                             starts, ends, n_layers, e_out, iters_out,
                             conv_out, post_out);
    std::vector<std::thread> pool;
    pool.reserve(T);
    const int per = (B + T - 1) / T;
    for (int t = 0; t < T; ++t) {
        const int b0 = t * per;
        const int b1 = std::min(B, b0 + per);
        if (b0 >= b1) break;
        pool.emplace_back([=] {
            bp_decode_cpu(H, m, n, &syndromes[(size_t)b0 * m], b1 - b0,
                          p, max_iter, starts, ends, n_layers,
                          &e_out[(size_t)b0 * n], &iters_out[b0],
                          &conv_out[b0],
                          post_out ? &post_out[(size_t)b0 * n] : nullptr);
        });
    }
    for (auto& th : pool) th.join();
    return 0;
}

// ---------------------------------------------------------------------------
// Batched CPU ordered-statistics post-decoder matching the framework's OSD
// semantics (qldpcsim_jax/decoders/osd.py; reference control flow
// decoders.py:299-369 with the corrected independent 2^order enumeration):
//   reliability = max(prob, 1-prob) from float32 LLRs clipped to +-100,
//   stable ascending argsort, least-reliable-basis by first-independent
//   permuted columns (bit-packed RREF with tag vectors), candidate solve by
//   tag fold, minimum weight with first-wins ties.
// posterior arrives as float64 (BP oracle) and is cast to float32 first,
// exactly like the Python oracle (tests/oracle.py osd_decode).
// ---------------------------------------------------------------------------
int osd_decode_cpu(const int8_t* H, int m, int n, int rank,
                   const int8_t* e_hat_in, const int8_t* syndromes,
                   const double* posterior, int B, int order,
                   int8_t* e_out) {
    const int mW = (m + 63) >> 6;
    const int rW = (rank + 63) >> 6;
    // packed columns of H (bits over checks)
    std::vector<uint64_t> colbits((size_t)n * mW, 0);
    for (int i = 0; i < m; ++i)
        for (int j = 0; j < n; ++j)
            if (H[(size_t)i * n + j])
                colbits[(size_t)j * mW + (i >> 6)] |= 1ULL << (i & 63);

    const int n_pat = 1 << order;
    std::vector<int> perm(n);
    std::vector<float> rel(n);
    std::vector<uint64_t> basis((size_t)rank * mW);
    std::vector<uint64_t> tags((size_t)rank * rW);
    std::vector<int> pivots(rank), cis(rank), info;
    std::vector<uint64_t> v(mW), t(rW), s0(mW), sJ(mW), x(rW), bx(rW);
    info.reserve(n);

    for (int b = 0; b < B; ++b) {
        const int8_t* eh = &e_hat_in[(size_t)b * n];
        const int8_t* syn = &syndromes[(size_t)b * m];
        const double* post = &posterior[(size_t)b * n];
        for (int j = 0; j < n; ++j) {
            float llr = (float)post[j];
            if (llr > 100.0f) llr = 100.0f;
            if (llr < -100.0f) llr = -100.0f;
            const float pr = 1.0f / (1.0f + std::exp(llr));
            rel[j] = std::max(pr, 1.0f - pr);
            perm[j] = j;
        }
        std::stable_sort(perm.begin(), perm.end(),
                         [&](int a, int c) { return rel[a] < rel[c]; });

        // least-reliable basis: first `rank` independent permuted columns
        std::fill(basis.begin(), basis.end(), 0);
        std::fill(tags.begin(), tags.end(), 0);
        int cnt = 0;
        info.clear();
        for (int jj = 0; jj < n; ++jj) {
            const int j = perm[jj];
            if (cnt < rank) {
                std::memcpy(v.data(), &colbits[(size_t)j * mW],
                            mW * sizeof(uint64_t));
                std::fill(t.begin(), t.end(), 0);
                for (int k = 0; k < cnt; ++k) {
                    const int pv = pivots[k];
                    if ((v[pv >> 6] >> (pv & 63)) & 1ULL) {
                        for (int w = 0; w < mW; ++w)
                            v[w] ^= basis[(size_t)k * mW + w];
                        for (int w = 0; w < rW; ++w)
                            t[w] ^= tags[(size_t)k * rW + w];
                    }
                }
                int pnew = -1;
                for (int w = 0; w < mW && pnew < 0; ++w)
                    if (v[w]) pnew = (w << 6) + __builtin_ctzll(v[w]);
                if (pnew >= 0) {
                    t[cnt >> 6] ^= 1ULL << (cnt & 63);  // self tag
                    // back-eliminate the new pivot from existing rows
                    for (int k = 0; k < cnt; ++k) {
                        if ((basis[(size_t)k * mW + (pnew >> 6)]
                             >> (pnew & 63)) & 1ULL) {
                            for (int w = 0; w < mW; ++w)
                                basis[(size_t)k * mW + w] ^= v[w];
                            for (int w = 0; w < rW; ++w)
                                tags[(size_t)k * rW + w] ^= t[w];
                        }
                    }
                    std::memcpy(&basis[(size_t)cnt * mW], v.data(),
                                mW * sizeof(uint64_t));
                    std::memcpy(&tags[(size_t)cnt * rW], t.data(),
                                rW * sizeof(uint64_t));
                    pivots[cnt] = pnew;
                    cis[cnt] = jj;  // permuted position of this basis column
                    ++cnt;
                    continue;
                }
            }
            info.push_back(jj);
        }

        // s0 = syndrome XOR H_perm[:, info] @ e_info; base info weight
        std::fill(s0.begin(), s0.end(), 0);
        for (int i = 0; i < m; ++i)
            if (syn[i]) s0[i >> 6] ^= 1ULL << (i & 63);
        int base_w = 0;
        for (const int jj : info) {
            const int j = perm[jj];
            if (eh[j]) {
                ++base_w;
                for (int w = 0; w < mW; ++w)
                    s0[w] ^= colbits[(size_t)j * mW + w];
            }
        }

        int best_wgt = -1, best_pat = 0;
        for (int pat = 0; pat < n_pat; ++pat) {
            std::memcpy(sJ.data(), s0.data(), mW * sizeof(uint64_t));
            int winfo = base_w;
            for (int k = 0; k < order && k < (int)info.size(); ++k) {
                if ((pat >> k) & 1) {
                    const int j = perm[info[k]];
                    for (int w = 0; w < mW; ++w)
                        sJ[w] ^= colbits[(size_t)j * mW + w];
                    winfo += 1 - 2 * (int)eh[j];
                }
            }
            std::fill(x.begin(), x.end(), 0);
            for (int k = 0; k < cnt; ++k) {
                const int pv = pivots[k];
                if ((sJ[pv >> 6] >> (pv & 63)) & 1ULL)
                    for (int w = 0; w < rW; ++w)
                        x[w] ^= tags[(size_t)k * rW + w];
            }
            int wgt = winfo;
            for (int w = 0; w < rW; ++w) wgt += __builtin_popcountll(x[w]);
            if (best_wgt < 0 || wgt < best_wgt) {  // first-wins ties
                best_wgt = wgt;
                best_pat = pat;
                std::memcpy(bx.data(), x.data(), rW * sizeof(uint64_t));
            }
        }

        // reconstruct winning candidate in original column order
        int8_t* out = &e_out[(size_t)b * n];
        for (int j = 0; j < n; ++j) out[j] = eh[j];
        for (int k = 0; k < order && k < (int)info.size(); ++k)
            if ((best_pat >> k) & 1) out[perm[info[k]]] ^= 1;
        for (int k = 0; k < cnt; ++k)
            out[perm[cis[k]]] = (int8_t)((bx[k >> 6] >> (k & 63)) & 1ULL);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Multithreaded batch wrapper: splits shots across up to `threads` workers
// (0 = hardware concurrency). Each worker runs the single-threaded decoder
// on its contiguous shot range — embarrassingly parallel, bit-identical to
// the sequential version.
// ---------------------------------------------------------------------------
int ms_decode_cpu_mt(const int8_t* H, int m, int n,
                     const int8_t* syndromes, int B,
                     float p, int max_iter, float beta,
                     const int32_t* starts, const int32_t* ends, int n_layers,
                     int8_t* e_out, int32_t* iters_out, int8_t* conv_out,
                     float* post_out, int threads) {
    int T = threads > 0 ? threads
                        : (int)std::thread::hardware_concurrency();
    if (T < 1) T = 1;
    if (T > B) T = B;
    if (T == 1)
        return ms_decode_cpu(H, m, n, syndromes, B, p, max_iter, beta,
                             starts, ends, n_layers, e_out, iters_out,
                             conv_out, post_out);
    std::vector<std::thread> pool;
    pool.reserve(T);
    const int per = (B + T - 1) / T;
    for (int t = 0; t < T; ++t) {
        const int b0 = t * per;
        const int b1 = std::min(B, b0 + per);
        if (b0 >= b1) break;
        pool.emplace_back([=] {
            ms_decode_cpu(H, m, n, &syndromes[(size_t)b0 * m], b1 - b0,
                          p, max_iter, beta, starts, ends, n_layers,
                          &e_out[(size_t)b0 * n], &iters_out[b0],
                          &conv_out[b0],
                          post_out ? &post_out[(size_t)b0 * n] : nullptr);
        });
    }
    for (auto& th : pool) th.join();
    return 0;
}

// ABI version handshake: qldpcsim_jax/gf2/native.py checks this after CDLL
// load and rebuilds on mismatch — bump whenever any exported signature
// changes (an mtime check alone cannot catch a stale .so after a checkout).
int gf2core_abi_version() { return 2; }

}  // extern "C"
