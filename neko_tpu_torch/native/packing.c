/* Native host-side packing kernels.
 *
 * The data-loader's hottest inner loop is turning a control episode slice
 * into the interleaved token stream:
 *   per timestep [mu-law(obs) bins | SEP | action bins]   (reference
 *   semantics: gato_policy.py:298-306,319-327,343-359 and
 *   input_tokenizers.py:17-30).
 * This C kernel fuses companding, binning, offsetting, interleaving and
 * mask/position generation into one pass so the host packing thread keeps
 * ahead of the device at large batch sizes.  Exact bit-parity with the numpy
 * route of data/packing.py (including the truncating int cast and the
 * unclipped top bin) is enforced by tests.
 *
 * Built with the system C compiler at first use and loaded through ctypes
 * (native/__init__.py) -- no pybind11 dependency.
 */

#include <math.h>
#include <stddef.h>
#include <stdint.h>

static inline int32_t bin_value(float x, int use_mu_law, float mu, float M,
                                float inv_log1p_muM, int n_bins, int offset) {
    if (use_mu_law) {
        float s = x < 0.0f ? -1.0f : (x > 0.0f ? 1.0f : 0.0f);
        x = s * log1pf(mu * fabsf(x)) * inv_log1p_muM;
    }
    if (x < -1.0f) x = -1.0f;
    if (x > 1.0f) x = 1.0f;
    /* truncating cast, matching numpy/torch .astype(int32) */
    int32_t b = (int32_t)((x + 1.0f) * ((float)n_bins / 2.0f));
    return b + offset;
}

/* Continuous-obs / continuous-action episode -> token stream.
 * obs: [T, O] float32, act: [T, A] float32.
 * tokens/target/inner: [T * (O + 1 + A)] outputs.
 * Returns the total token count. */
int pack_continuous_control(
    const float* obs, int T, int O,
    const float* act, int A,
    float mu, float M, int n_bins,
    int cont_start, int sep_id,
    int32_t* tokens, uint8_t* target, int32_t* inner) {
    const float inv = 1.0f / logf(1.0f + mu * M);
    const int k = O + 1 + A;
    for (int t = 0; t < T; ++t) {
        int32_t* tok = tokens + (size_t)t * k;
        uint8_t* tg = target + (size_t)t * k;
        int32_t* in = inner + (size_t)t * k;
        const float* o = obs + (size_t)t * O;
        const float* a = act + (size_t)t * A;
        for (int i = 0; i < O; ++i) {
            tok[i] = bin_value(o[i], 1, mu, M, inv, n_bins, cont_start);
            tg[i] = 0;
            in[i] = i;
        }
        tok[O] = sep_id;
        tg[O] = 0;
        in[O] = -1;
        for (int i = 0; i < A; ++i) {
            tok[O + 1 + i] = bin_value(a[i], 0, mu, M, inv, n_bins, cont_start);
            tg[O + 1 + i] = 1;
            in[O + 1 + i] = -1;
        }
    }
    return T * k;
}

/* Discrete-obs / discrete-action variant: obs [T, O] int32, act [T, A] int32,
 * both offset by disc_start. */
int pack_discrete_control(
    const int32_t* obs, int T, int O,
    const int32_t* act, int A,
    int disc_start, int sep_id,
    int32_t* tokens, uint8_t* target, int32_t* inner) {
    const int k = O + 1 + A;
    for (int t = 0; t < T; ++t) {
        int32_t* tok = tokens + (size_t)t * k;
        uint8_t* tg = target + (size_t)t * k;
        int32_t* in = inner + (size_t)t * k;
        const int32_t* o = obs + (size_t)t * O;
        const int32_t* a = act + (size_t)t * A;
        for (int i = 0; i < O; ++i) {
            tok[i] = o[i] + disc_start;
            tg[i] = 0;
            in[i] = i;
        }
        tok[O] = sep_id;
        tg[O] = 0;
        in[O] = -1;
        for (int i = 0; i < A; ++i) {
            tok[O + 1 + i] = a[i] + disc_start;
            tg[O + 1 + i] = 1;
            in[O + 1 + i] = -1;
        }
    }
    return T * k;
}

/* Mixed continuous-obs / discrete-action (MuJoCo-style obs, Atari actions
 * never co-occur in the reference, but Box obs + Discrete act envs exist). */
int pack_continuous_obs_discrete_act(
    const float* obs, int T, int O,
    const int32_t* act, int A,
    float mu, float M, int n_bins,
    int cont_start, int disc_start, int sep_id,
    int32_t* tokens, uint8_t* target, int32_t* inner) {
    const float inv = 1.0f / logf(1.0f + mu * M);
    const int k = O + 1 + A;
    for (int t = 0; t < T; ++t) {
        int32_t* tok = tokens + (size_t)t * k;
        uint8_t* tg = target + (size_t)t * k;
        int32_t* in = inner + (size_t)t * k;
        const float* o = obs + (size_t)t * O;
        const int32_t* a = act + (size_t)t * A;
        for (int i = 0; i < O; ++i) {
            tok[i] = bin_value(o[i], 1, mu, M, inv, n_bins, cont_start);
            tg[i] = 0;
            in[i] = i;
        }
        tok[O] = sep_id;
        tg[O] = 0;
        in[O] = -1;
        for (int i = 0; i < A; ++i) {
            tok[O + 1 + i] = a[i] + disc_start;
            tg[O + 1 + i] = 1;
            in[O + 1 + i] = -1;
        }
    }
    return T * k;
}
