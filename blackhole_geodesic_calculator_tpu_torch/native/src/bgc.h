/* bgc native runtime -- C API.
 *
 * The reference delegates its numerical hot layer to scipy's compiled RK45
 * core (one solve_ivp per pixel, reference
 * raytracer/RelativisticRenderEngine.py:293-294, README.md:196) and its IO
 * to Blender's C++ (bpy.data.images / RenderResult,
 * RelativisticRenderEngine.py:78-90,158-168).  This library is the
 * framework's native equivalent of both:
 *
 *   1. a double-precision adaptive Dormand-Prince 5(4) geodesic integrator
 *      (the f64 validation oracle for the TPU Pallas/XLA paths, and the
 *      fast CPU path for trajectory extraction / curvedpy-compat calls),
 *      multithreaded over the ray batch;
 *   2. PNG (zlib) + PFM image encode/decode;
 *   3. an asynchronous frame-writer pipeline (thread pool) that overlaps
 *      host-side tonemap/encode/disk IO with device compute during
 *      animation rendering.
 *
 * Bound from Python via ctypes (no pybind11 on this image).
 */
#ifndef BGC_NATIVE_H
#define BGC_NATIVE_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Ray status codes -- MUST match ops/states.py. */
enum BgcStatus {
  BGC_ACTIVE = 0,
  BGC_CAPTURED = 1,
  BGC_ESCAPED = 2,
  BGC_BUDGET = 3,
  BGC_DISK = 4,
  BGC_OBJECT = 5,
  BGC_INSIDE_HORIZON = 6,
  BGC_ERROR = 7,
};

/* Spacetime + termination + event geometry (mirrors ops/integrate.GeodesicEnv). */
typedef struct {
  double mass;
  double spin;        /* Kerr-Schild spin a; 0 selects the Schwarzschild fast path */
  double r_capture;
  double r_escape;
  double lam_max;
  double disk_r_in;   /* z=0 annulus; disabled when disk_r_out <= 0 */
  double disk_r_out;
  const double* spheres; /* (n_spheres, 4): cx cy cz radius; may be NULL */
  int n_spheres;
} BgcEnv;

/* Adaptive-stepper controls (parity with scipy solve_ivp's RK45 defaults). */
typedef struct {
  double rtol;      /* <=0 -> 1e-8 */
  double atol;      /* <=0 -> 1e-10 */
  double max_step;  /* <=0 -> inf */
  double min_step;  /* <=0 -> 1e-12 */
  double first_step;/* <=0 -> auto */
  long   max_evals; /* RHS-evaluation budget per ray; <=0 -> 1e7 */
} BgcSolverOpts;

/* Integrate a batch of null geodesics from (x0, unit d0) until termination.
 * x0, d0: (n, 3) row-major.  Outputs (all length n unless noted):
 *   x_out, p_out (n, 3): final position / spatial momentum,
 *   lam_out: affine length at termination,
 *   status_out: BgcStatus, hit_obj_out: sphere index or -1,
 *   n_steps_out (nullable): accepted steps per ray.
 * n_threads <= 0 -> hardware_concurrency.  Returns 0 on success. */
int bgc_integrate_batch(
    const double* x0, const double* d0, int64_t n,
    const BgcEnv* env, const BgcSolverOpts* opts, int n_threads,
    double* x_out, double* p_out, double* lam_out,
    int32_t* status_out, int32_t* hit_obj_out, int32_t* n_steps_out);

/* Integrate ONE ray, storing every accepted step point (the reference's
 * calc_trajectory polyline, RelativisticRenderEngine.py:293-308).
 * traj_x: (max_points, 3), traj_p: (max_points, 3), traj_lam: (max_points,).
 * Writes the realized point count to *n_points (clamped to max_points;
 * sampling stays uniform-by-step: once full, the tail keeps the last point).
 * Returns the final BgcStatus. */
int bgc_trajectory(
    const double* x0, const double* d0,
    const BgcEnv* env, const BgcSolverOpts* opts,
    int32_t max_points, double* traj_x, double* traj_p, double* traj_lam,
    int32_t* n_points, double* lam_out, int32_t* hit_obj_out);

/* Batched dense trajectories: integrate n rays MULTITHREADED, each storing
 * its accepted-step polyline of positions AND coordinate velocities
 * (dx/dlambda -- what the compat calc_trajectory contract returns as k).
 * traj_x, traj_v: (n, max_points, 3) row-major; traj_lam: (n, max_points).
 * Point 0 of every ray is the launch state.  Per-ray realized counts in
 * n_points_out (n,); clamping semantics as bgc_trajectory.  E_out (n,)
 * gets each ray's conserved energy (nullable).  n_threads <= 0 ->
 * hardware_concurrency.  Returns 0 on success. */
int bgc_trajectory_batch(
    const double* x0, const double* d0, int64_t n,
    const BgcEnv* env, const BgcSolverOpts* opts,
    int32_t max_points, int n_threads,
    double* traj_x, double* traj_v, double* traj_lam,
    int32_t* n_points_out, double* lam_out,
    int32_t* status_out, int32_t* hit_obj_out, double* E_out);

/* Null-geodesic RHS at one state (for parity unit tests): given x (3,),
 * p (3,), E, writes dx (3,) and dp (3,). */
void bgc_rhs(const double* x, const double* p, double E,
             double mass, double spin, double* dx, double* dp);

/* Batched RHS over n states (x, p: (n, 3)); one ctypes crossing recovers
 * the coordinate velocities of a whole trajectory polyline. */
void bgc_rhs_batch(const double* x, const double* p, int64_t n, double E,
                   double mass, double spin, double* dx, double* dp);

/* Initial (p, E) of a photon at x with unit coordinate velocity d
 * (ops/geodesic.null_init). */
void bgc_null_init(const double* x, const double* d,
                   double mass, double spin, double* p_out, double* E_out);

/* ---------------- image IO ---------------- */

/* Encode (h, w, c) uint8 (c = 3 or 4) as PNG.  Returns 0 on success. */
int bgc_write_png(const char* path, const uint8_t* data,
                  int32_t h, int32_t w, int32_t c, int32_t compress_level);

/* Decode a PNG written by this library (8-bit RGB/RGBA, all filter types).
 * Pass data=NULL to query the shape.  Returns 0 on success. */
int bgc_read_png(const char* path, uint8_t* data,
                 int32_t* h, int32_t* w, int32_t* c);

/* Portable Float Map: (h, w, 3) float32, for lossless golden images. */
int bgc_write_pfm(const char* path, const float* data, int32_t h, int32_t w);
int bgc_read_pfm(const char* path, float* data, int32_t* h, int32_t* w);

/* float [0,1] HWC -> uint8, optional sRGB transfer; out size h*w*c. */
void bgc_quantize(const float* in, uint8_t* out, int64_t n_px, int32_t c,
                  int32_t srgb);

/* ---------------- async frame writer ---------------- */

typedef struct BgcWriter BgcWriter;

/* Thread-pool PNG writer: submit copies the float framebuffer and returns
 * immediately; worker threads quantize, encode and write to disk. */
BgcWriter* bgc_writer_create(int n_threads);
/* data: (h, w, c) float32 in [0, 1].  Returns 0 if queued. */
int bgc_writer_submit_u8(BgcWriter* wr, const char* path,
                         const uint8_t* data, int32_t h, int32_t w,
                         int32_t c);
int bgc_writer_submit(BgcWriter* wr, const char* path, const float* data,
                      int32_t h, int32_t w, int32_t c, int32_t srgb);
/* Block until the queue drains; returns the number of failed writes. */
int bgc_writer_wait(BgcWriter* wr);
void bgc_writer_destroy(BgcWriter* wr);

#ifdef __cplusplus
}
#endif
#endif /* BGC_NATIVE_H */
