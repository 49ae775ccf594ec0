// Native voxelizer: exact triangle-box surface rasterization + parity fill
// (the port's own copy of the JAX package's voxelize.cpp, same arithmetic).
//
// Two entry points matching the numpy semantics of
// featurenet_tpu_torch/data/voxelize.py:
//
//   fill=0  -> surface shell: voxel marked iff its axis-aligned box
//              geometrically intersects any triangle (Akenine-Möller SAT —
//              exact, a superset of the numpy sampling rasterizer).
//   fill=1  -> center-inside solid: vertical-ray parity per voxel-center
//              column, identical jitter constants to the numpy path so the
//              two backends agree bit-for-bit on watertight meshes.
//
// Parallelism: OpenMP over triangles; toggles accumulate with atomics
// (surface writes are idempotent |=, races are benign by value), so the
// result does not depend on the thread count. A mesh of fewer than
// kMinParallelTris triangles (a part below ~48^3) runs on one thread:
// waking the team costs more than its work.
//
// Build: g++ -O3 -shared -fPIC -fopenmp (featurenet_tpu_torch/native/__init__.py
// builds it at first use into build/native/).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include <omp.h>

namespace {

constexpr long kMinParallelTris = 16384;

struct V3 {
  double x, y, z;
};

inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline double dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

inline void minmax3(double a, double b, double c, double& lo, double& hi) {
  lo = a < b ? (a < c ? a : c) : (b < c ? b : c);
  hi = a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// Akenine-Möller triangle/AABB overlap. Box centered at `c` with half-size h
// (cubic). Vertices are pre-translated into box space by the caller.
bool tri_box_overlap(const V3& c, double h, V3 v0, V3 v1, V3 v2) {
  v0 = sub(v0, c);
  v1 = sub(v1, c);
  v2 = sub(v2, c);
  V3 e0 = sub(v1, v0), e1 = sub(v2, v1), e2 = sub(v0, v2);

  double lo, hi;
  // 1) AABB overlap on the three coordinate axes.
  minmax3(v0.x, v1.x, v2.x, lo, hi);
  if (lo > h || hi < -h) return false;
  minmax3(v0.y, v1.y, v2.y, lo, hi);
  if (lo > h || hi < -h) return false;
  minmax3(v0.z, v1.z, v2.z, lo, hi);
  if (lo > h || hi < -h) return false;

  // 2) Plane of the triangle vs box.
  V3 n = cross(e0, e1);
  double d = -dot(n, v0);
  double r = h * (std::fabs(n.x) + std::fabs(n.y) + std::fabs(n.z));
  if (std::fabs(d) > r) return false;

  // 3) Nine cross-product axes a_ij = e_i x unit_j.
  auto axis_test = [&](double ax, double ay, double az) {
    double p0 = ax * v0.x + ay * v0.y + az * v0.z;
    double p1 = ax * v1.x + ay * v1.y + az * v1.z;
    double p2 = ax * v2.x + ay * v2.y + az * v2.z;
    double mn = std::fmin(p0, std::fmin(p1, p2));
    double mx = std::fmax(p0, std::fmax(p1, p2));
    double rad = h * (std::fabs(ax) + std::fabs(ay) + std::fabs(az));
    return mn <= rad && mx >= -rad;
  };
  const V3 es[3] = {e0, e1, e2};
  for (const V3& e : es) {
    if (!axis_test(0, -e.z, e.y)) return false;   // e x X
    if (!axis_test(e.z, 0, -e.x)) return false;   // e x Y
    if (!axis_test(-e.y, e.x, 0)) return false;   // e x Z
  }
  return true;
}

}  // namespace

extern "C" {

// The OpenMP threads a parallel region here runs on.
int fn_omp_max_threads() { return omp_get_max_threads(); }

// tris: float32 [n, 3, 3] already normalized into [0,1]^3 (voxelize.py does
// normalize_mesh first). out: uint8 [R*R*R], C-order [x][y][z]. Returns 0.
int fn_voxelize_surface(const float* tris, long n_tris, int R, uint8_t* out) {
  // Conservative: boxes are inflated by EPS voxels so float32 rounding in
  // callers (mesh data is fp32) can never make a genuinely-touched voxel
  // test negative. Keeps the shell a guaranteed superset of any on-triangle
  // point sampling.
  const double EPS = 1e-4;
  std::memset(out, 0, (size_t)R * R * R);
#pragma omp parallel for schedule(dynamic, 64) if (n_tris >= kMinParallelTris)
  for (long t = 0; t < n_tris; ++t) {
    const float* p = tris + t * 9;
    // Voxel coordinates: voxel i spans [i, i+1).
    V3 v0{p[0] * R, p[1] * R, p[2] * R};
    V3 v1{p[3] * R, p[4] * R, p[5] * R};
    V3 v2{p[6] * R, p[7] * R, p[8] * R};
    double lo, hi;
    int x0, x1, y0, y1, z0, z1;
    minmax3(v0.x, v1.x, v2.x, lo, hi);
    x0 = std::max(0, (int)std::floor(lo - EPS));
    x1 = std::min(R - 1, (int)std::floor(hi + EPS));
    minmax3(v0.y, v1.y, v2.y, lo, hi);
    y0 = std::max(0, (int)std::floor(lo - EPS));
    y1 = std::min(R - 1, (int)std::floor(hi + EPS));
    minmax3(v0.z, v1.z, v2.z, lo, hi);
    z0 = std::max(0, (int)std::floor(lo - EPS));
    z1 = std::min(R - 1, (int)std::floor(hi + EPS));
    for (int x = x0; x <= x1; ++x)
      for (int y = y0; y <= y1; ++y)
        for (int z = z0; z <= z1; ++z) {
          V3 c{x + 0.5, y + 0.5, z + 0.5};
          if (tri_box_overlap(c, 0.5 + EPS, v0, v1, v2))
            out[((size_t)x * R + y) * R + z] = 1;  // idempotent; race-benign
        }
  }
  return 0;
}

// Center-inside parity fill; numerically identical to
// voxelize.py::_voxelize_parity (same jitter, same ceil rule).
int fn_voxelize_fill(const float* tris, long n_tris, int R, uint8_t* out) {
  const double ex = 7.3e-7, ey = 3.1e-7;
  std::vector<int> toggles((size_t)R * R * (R + 1), 0);
#pragma omp parallel for schedule(dynamic, 64) if (n_tris >= kMinParallelTris)
  for (long t = 0; t < n_tris; ++t) {
    const float* p = tris + t * 9;
    double x0 = p[0] * R, y0 = p[1] * R, z0 = p[2] * R;
    double x1 = p[3] * R, y1 = p[4] * R, z1 = p[5] * R;
    double x2 = p[6] * R, y2 = p[7] * R, z2 = p[8] * R;
    double det = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2);
    if (std::fabs(det) < 1e-12) continue;
    int ix_lo = std::max(0, (int)std::ceil(std::fmin(x0, std::fmin(x1, x2)) - 0.5 - ex));
    int ix_hi = std::min(R - 1, (int)std::floor(std::fmax(x0, std::fmax(x1, x2)) - 0.5 - ex));
    int iy_lo = std::max(0, (int)std::ceil(std::fmin(y0, std::fmin(y1, y2)) - 0.5 - ey));
    int iy_hi = std::min(R - 1, (int)std::floor(std::fmax(y0, std::fmax(y1, y2)) - 0.5 - ey));
    for (int ix = ix_lo; ix <= ix_hi; ++ix) {
      double px = ix + 0.5 + ex;
      for (int iy = iy_lo; iy <= iy_hi; ++iy) {
        double py = iy + 0.5 + ey;
        double a = ((y1 - y2) * (px - x2) + (x2 - x1) * (py - y2)) / det;
        double b = ((y2 - y0) * (px - x2) + (x0 - x2) * (py - y2)) / det;
        double c = 1.0 - a - b;
        if (a < 0 || b < 0 || c < 0) continue;
        double zstar = a * z0 + b * z1 + c * z2;
        long k = (long)std::ceil(zstar - 0.5);
        if (k < 0) k = 0;
        if (k > R) k = R;
#pragma omp atomic
        toggles[((size_t)ix * R + iy) * (R + 1) + k] += 1;
      }
    }
  }
  for (int x = 0; x < R; ++x)
    for (int y = 0; y < R; ++y) {
      int par = 0;
      const int* col = &toggles[((size_t)x * R + y) * (R + 1)];
      uint8_t* o = &out[((size_t)x * R + y) * R];
      for (int z = 0; z < R; ++z) {
        par ^= (col[z] & 1);
        o[z] = (uint8_t)par;
      }
    }
  return 0;
}

}  // extern "C"
