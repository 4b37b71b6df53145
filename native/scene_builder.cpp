// Native scene builder: C++ implementation of the host-side scene assembly.
//
// The reference builds scenes in host C++ (CudaTracer/Scene.cpp:17-371); this
// is this framework's native equivalent, exporting a C ABI consumed via
// ctypes (cuda_path_tracer_ss/native.py). It reproduces the same
// geometry, including the MSVC rand() stream that the reference's unseeded
// rnd() macro consumes (Scene.cpp:3), with right-to-left vec3 argument
// evaluation as MSVC performed it.
//
// The pure-Python builder (models/scene.py + models/presets.py) is the
// fallback and the oracle; tests assert bit-identical output.
//
// Preset coverage: this module builds the five reference scene constructors
// (cornell / mirror-box / random / glass / defined spheres) and their
// composites. The framework's additional Python-only presets — `stress`
// (parametric sphere fields) and `mesh` (OBJ import via utils/obj.py) — are
// intentionally NOT duplicated here: they have no reference counterpart and
// no MSVC-rand bit-parity requirement, so the Python builder is their single
// source of truth.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr float kPi = 3.14159265358979323846f;

// ---------------------------------------------------------------------------
// MSVC CRT rand(): state = state * 214013 + 2531011; return (state >> 16) & 0x7fff
// ---------------------------------------------------------------------------
struct MsvcRand {
  uint32_t state = 1;
  int rand() {
    state = state * 214013u + 2531011u;
    return static_cast<int>((state >> 16) & 0x7fff);
  }
  float rnd(float x) { return x * static_cast<float>(rand()) / 32767.0f; }
  int rnd_int(int x) { return x * rand() / 32767; }
};

// ---------------------------------------------------------------------------
// Minimal 4x4 / vec3 math (column-major-free: plain row-major arrays)
// ---------------------------------------------------------------------------
struct Vec3 {
  float x = 0, y = 0, z = 0;
};

struct Mat4 {
  float m[16] = {1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1};
};

Mat4 matmul(const Mat4 &a, const Mat4 &b) {
  Mat4 r;
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++) {
      float s = 0;
      for (int k = 0; k < 4; k++) s += a.m[i * 4 + k] * b.m[k * 4 + j];
      r.m[i * 4 + j] = s;
    }
  return r;
}

Mat4 translate(float x, float y, float z) {
  Mat4 r;
  r.m[3] = x;
  r.m[7] = y;
  r.m[11] = z;
  return r;
}

Mat4 scale(float s) {
  Mat4 r;
  r.m[0] = r.m[5] = r.m[10] = s;
  return r;
}

Mat4 rotate_deg(float deg, float ax, float ay, float az) {
  float a = deg * kPi / 180.0f;
  float n = std::sqrt(ax * ax + ay * ay + az * az);
  ax /= n;
  ay /= n;
  az /= n;
  float c = std::cos(a), s = std::sin(a), C = 1 - c;
  Mat4 r;
  float rot[9] = {c + ax * ax * C,      ax * ay * C - az * s, ax * az * C + ay * s,
                  ay * ax * C + az * s, c + ay * ay * C,      ay * az * C - ax * s,
                  az * ax * C - ay * s, az * ay * C + ax * s, c + az * az * C};
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) r.m[i * 4 + j] = rot[i * 3 + j];
  return r;
}

Vec3 transform_point(const Mat4 &t, float x, float y, float z) {
  Vec3 r;
  r.x = t.m[0] * x + t.m[1] * y + t.m[2] * z + t.m[3];
  r.y = t.m[4] * x + t.m[5] * y + t.m[6] * z + t.m[7];
  r.z = t.m[8] * x + t.m[9] * y + t.m[10] * z + t.m[11];
  return r;
}

// normal via inverse-transpose, as Scene.cpp:81-85
Vec3 transform_normal(const Mat4 &t, float x, float y, float z) {
  // inverse of the upper-left 3x3 (the transforms used are affine)
  const float *m = t.m;
  float a = m[0], b = m[1], c = m[2];
  float d = m[4], e = m[5], f = m[6];
  float g = m[8], h = m[9], i = m[10];
  float det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
  float id = 1.0f / det;
  // inverse (3x3), then transpose applied to (x, y, z): n' = (M^-1)^T n
  float inv[9] = {(e * i - f * h) * id, (c * h - b * i) * id, (b * f - c * e) * id,
                  (f * g - d * i) * id, (a * i - c * g) * id, (c * d - a * f) * id,
                  (d * h - e * g) * id, (b * g - a * h) * id, (a * e - b * d) * id};
  Vec3 r;
  r.x = inv[0] * x + inv[3] * y + inv[6] * z;
  r.y = inv[1] * x + inv[4] * y + inv[7] * z;
  r.z = inv[2] * x + inv[5] * y + inv[8] * z;
  float n = std::sqrt(r.x * r.x + r.y * r.y + r.z * r.z);
  r.x /= n;
  r.y /= n;
  r.z /= n;
  return r;
}

// ---------------------------------------------------------------------------
// Builder state
// ---------------------------------------------------------------------------
struct Material {
  float diffuse[3] = {0, 0, 0};
  float specular[3] = {0, 0, 0};
  float absorption[3] = {0, 0, 0};
  float emission[3] = {0, 0, 0};
  float spec_exp = 0, ior = 1, diff_avg = 0, spec_avg = 0, refr_avg = 0,
        roughness = 0;
  int flags = 0;
};

struct Builder {
  std::vector<float> sph;       // x y z r  per sphere
  std::vector<int> sph_mat;
  std::vector<float> tri;       // v0 v1 v2 n0 n1 n2 (18 floats) per triangle
  std::vector<int> tri_mat;
  std::vector<Material> mats;
  std::vector<float> pl;        // pos power (6 floats) per point light
  std::vector<float> al_power;  // 3 floats
  std::vector<float> al_area;
  std::vector<int> al_tri0;
  MsvcRand rng;

  int add_material(const Material &m) {
    mats.push_back(m);
    return static_cast<int>(mats.size()) - 1;
  }

  void add_sphere(float x, float y, float z, float r, int mat) {
    sph.insert(sph.end(), {x, y, z, r});
    sph_mat.push_back(mat);
  }

  void add_point_light(float x, float y, float z, float pr, float pg,
                       float pb) {
    pl.insert(pl.end(), {x, y, z, pr, pg, pb});
  }

  void add_tri(const Vec3 &v0, const Vec3 &v1, const Vec3 &v2, const Vec3 &n,
               int mat) {
    float row[18] = {v0.x, v0.y, v0.z, v1.x, v1.y, v1.z, v2.x, v2.y, v2.z,
                     n.x,  n.y,  n.z,  n.x,  n.y,  n.z,  n.x,  n.y,  n.z};
    tri.insert(tri.end(), row, row + 18);
    tri_mat.push_back(mat);
  }

  // Scene.cpp:63-96 — unit rect under a transform, 2 triangles
  void add_rect(const Mat4 &t, int mat) {
    Vec3 v[4];
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 2; j++)
        v[2 * i + j] = transform_point(t, i - 0.5f, j - 0.5f, 0.0f);
    Vec3 n = transform_normal(t, 0, 0, 1);
    add_tri(v[0], v[1], v[2], n, mat);
    add_tri(v[3], v[1], v[2], n, mat);
  }

  // Scene.cpp:40-55
  void add_area_light(const Mat4 &t, int mat, float pr, float pg, float pb) {
    int tri0 = static_cast<int>(tri_mat.size());
    add_rect(t, mat);
    const float *a = &tri[tri0 * 18];
    float e1[3] = {a[3] - a[6], a[4] - a[7], a[5] - a[8]};   // v1 - v2
    float e2[3] = {a[6] - a[0], a[7] - a[1], a[8] - a[2]};   // v2 - v0
    float cx = e1[1] * e2[2] - e1[2] * e2[1];
    float cy = e1[2] * e2[0] - e1[0] * e2[2];
    float cz = e1[0] * e2[1] - e1[1] * e2[0];
    al_power.insert(al_power.end(), {pr, pg, pb});
    al_area.push_back(std::sqrt(cx * cx + cy * cy + cz * cz));
    al_tri0.push_back(tri0);
  }
};

Material glass(float ar, float ag, float ab) {
  Material m;
  m.diffuse[0] = m.diffuse[1] = m.diffuse[2] = 1.0f;
  m.specular[0] = m.specular[1] = m.specular[2] = 1.0f;
  m.spec_exp = INFINITY;
  m.spec_avg = 0.7f;
  m.ior = 1.55f;
  m.absorption[0] = ar;
  m.absorption[1] = ag;
  m.absorption[2] = ab;
  m.refr_avg = 0.7f;
  return m;
}

Material cook_torrance(float dr, float dg, float db, float sr, float sg,
                       float sb, float rough) {
  Material m;
  m.diffuse[0] = dr;
  m.diffuse[1] = dg;
  m.diffuse[2] = db;
  m.diff_avg = 0.1f;
  m.specular[0] = sr;
  m.specular[1] = sg;
  m.specular[2] = sb;
  m.spec_exp = INFINITY;
  m.spec_avg = 0.6f;
  m.ior = 1.7f;
  m.roughness = rough;
  m.flags = 0x03;
  return m;
}

Material diffuse3(float r, float g, float b, float avg = 0.7f) {
  Material m;
  m.diffuse[0] = r;
  m.diffuse[1] = g;
  m.diffuse[2] = b;
  m.diff_avg = avg;
  return m;
}

Material emitter(float r, float g, float b) {
  Material m;
  m.emission[0] = r;
  m.emission[1] = g;
  m.emission[2] = b;
  return m;
}

// Scene.cpp:173-225 (RTL arg evaluation: z draw first)
void add_random_spheres(Builder &b, size_t n) {
  int m0 = b.add_material(cook_torrance(1.0f, 0.1f, 0.1f, 1.0f, 0.2f, 0.2f, 0.3f));
  b.add_material(cook_torrance(0.1f, 0.1f, 1.0f, 0.2f, 0.2f, 1.0f, 0.1f));
  b.add_material(cook_torrance(0.1f, 1.0f, 0.1f, 0.2f, 1.0f, 0.2f, 0.5f));
  for (size_t i = 0; i < n; i++) {
    b.rng.rnd_int(1);
    b.rng.rnd_int(1);
    float z = b.rng.rnd(7.0f) - 9.0f;
    float y = b.rng.rnd(5.0f) - 2.5f;
    float x = b.rng.rnd(5.0f) - 2.5f;
    float r = b.rng.rnd(1.0f) + 0.2f;
    b.add_sphere(x, y, z, r, m0 + static_cast<int>(i % 3));
  }
}

// Scene.cpp:115-167
void add_random_glass_spheres(Builder &b, size_t n) {
  int m0 = b.add_material(glass(0.0f, 0.75f, 0.75f));
  b.add_material(glass(0.75f, 0.75f, 0.0f));
  b.add_material(glass(0.75f, 0.0f, 0.75f));
  for (size_t i = 0; i < n; i++) {
    b.rng.rnd_int(1);
    b.rng.rnd_int(1);
    b.rng.rnd_int(1);
    float z = b.rng.rnd(7.0f) - 9.0f;
    float y = b.rng.rnd(5.0f) - 2.5f;
    float x = b.rng.rnd(5.0f) - 2.5f;
    float r = b.rng.rnd(1.0f) + 0.2f;
    b.add_sphere(x, y, z, r, m0 + static_cast<int>(i % 3));
  }
}

// Scene.cpp:98-109
void add_defined_spheres(Builder &b, float size) {
  Material red;
  red.diffuse[0] = 1.0f;
  red.diff_avg = 0.35f;
  red.specular[0] = red.specular[1] = red.specular[2] = 1.0f;
  red.spec_exp = 250.0f;
  red.spec_avg = 0.6f;
  red.ior = 2.5f;
  int m0 = b.add_material(red);
  Material g;
  g.diffuse[0] = g.diffuse[1] = g.diffuse[2] = 1.0f;
  g.specular[0] = g.specular[1] = g.specular[2] = 1.0f;
  g.spec_exp = 300.0f;
  g.spec_avg = 0.9f;
  g.ior = 1.55f;
  g.absorption[0] = g.absorption[1] = 0.15f;
  g.refr_avg = 0.9f;
  b.add_material(g);
  b.add_sphere(-2.0f, -(size - 1.5f), -(size * 1.3f), 1.5f, m0 + 1);
  b.add_sphere(1.0f, -(size - 1.0f), -(size * 1.4f), 1.0f, m0);
}

// Scene.cpp:231-294
void add_cornell_box(Builder &b, float w) {
  int m0 = b.add_material(diffuse3(1.0f, 1.0f, 0.8f));
  b.add_material(diffuse3(1.0f, 0.0f, 0.0f));
  b.add_material(diffuse3(0.0f, 1.0f, 0.0f));
  b.add_material(emitter(1.0f, 1.0f, 1.0f));
  Material mirror;
  mirror.specular[0] = mirror.specular[1] = mirror.specular[2] = 1.0f;
  mirror.spec_exp = INFINITY;
  mirror.spec_avg = 0.8f;
  mirror.ior = 5.8f;
  b.add_material(mirror);

  float off = w / 2;
  Mat4 sw = scale(w);
  b.add_rect(matmul(matmul(translate(0, -off, -off), rotate_deg(-90, 1, 0, 0)), sw), m0);
  b.add_rect(matmul(matmul(translate(0, off, -off), rotate_deg(90, 1, 0, 0)), sw), m0);
  b.add_rect(matmul(matmul(translate(-off, 0, -off), rotate_deg(90, 0, 1, 0)), sw), m0 + 1);
  b.add_rect(matmul(matmul(translate(off, 0, -off), rotate_deg(-90, 0, 1, 0)), sw), m0 + 2);
  b.add_rect(matmul(matmul(translate(off - 0.02f, 0, -off), rotate_deg(-90, 0, 1, 0)), scale(w - 2)), m0 + 4);
  b.add_rect(matmul(translate(0, 0, -w), sw), m0);
  b.add_area_light(matmul(matmul(translate(0, off - 0.01f, -off), rotate_deg(90, 1, 0, 0)), scale(2.5f)), m0 + 3, 400, 400, 400);
}

// Scene.cpp:301-371
void add_mirror_box(Builder &b, float w) {
  int m0 = b.add_material(diffuse3(1.0f, 1.0f, 0.8f));
  b.add_material(diffuse3(1.0f, 0.0f, 0.0f));
  b.add_material(diffuse3(0.0f, 1.0f, 0.0f));
  b.add_material(emitter(1.0f, 1.0f, 1.0f));
  Material mirror;
  mirror.specular[0] = mirror.specular[1] = mirror.specular[2] = 1.0f;
  mirror.spec_exp = INFINITY;
  mirror.spec_avg = 0.9f;
  mirror.ior = 5.8f;
  mirror.flags = 0x01;
  b.add_material(mirror);
  b.add_material(emitter(1.0f, 0.6f, 1.0f));

  float off = w / 2;
  Mat4 sw = scale(w);
  b.add_rect(matmul(matmul(translate(0, -off, -off), rotate_deg(-90, 1, 0, 0)), sw), m0);
  b.add_rect(matmul(matmul(translate(0, off, -off), rotate_deg(90, 1, 0, 0)), sw), m0 + 4);
  b.add_rect(matmul(matmul(translate(-off + 0.2f * off, 0, -off), rotate_deg(88, 0, 1, 0)), sw), m0 + 4);
  b.add_rect(matmul(matmul(translate(off, 0, -off), rotate_deg(-90, 0, 1, 0)), sw), m0 + 4);
  b.add_rect(matmul(translate(0, 0, -w), sw), m0);
  b.add_rect(matmul(matmul(translate(0, 0, 0), rotate_deg(180, 0, 1, 0)), sw), m0);
  b.add_area_light(matmul(matmul(translate(0, off - 0.01f, -off), rotate_deg(90, 1, 0, 0)), scale(2.5f)), m0 + 3, 100, 400, 400);
  b.add_area_light(matmul(matmul(translate(0, -off + 0.01f, -off), rotate_deg(-90, 1, 0, 0)), scale(1.5f)), m0 + 5, 400.0f / 3, 0, 400.0f / 3);
}

Builder *build_preset(const char *name) {
  auto *b = new Builder();
  std::string s(name);
  if (s == "showcase" || s == "mirror_box") {
    add_random_spheres(*b, 5);
    add_random_glass_spheres(*b, 15);
    add_mirror_box(*b, 10);
  } else if (s == "cornell") {
    add_defined_spheres(*b, 4);
    add_cornell_box(*b, 8);
  } else if (s == "cornell_empty") {
    add_cornell_box(*b, 8);
  } else if (s == "glass") {
    add_random_glass_spheres(*b, 8);
    add_defined_spheres(*b, 4);
    add_cornell_box(*b, 8);
  } else if (s == "point_lights") {
    // mirrors presets.point_light_spheres (the reference ships these lights
    // disabled at Scene.cpp:21-22)
    b->add_point_light(0.0f, 0.0f, 2.5f, 500.0f, 500.0f, 500.0f);
    b->add_point_light(2.0f, 9.0f, -5.0f, 500.0f, 500.0f, 500.0f);
    add_defined_spheres(*b, 4);
    add_cornell_box(*b, 8);
  } else {
    delete b;
    return nullptr;
  }
  return b;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
extern "C" {

void *ptn_build_scene(const char *preset) {
  return build_preset(preset);
}

void ptn_free_scene(void *h) { delete static_cast<Builder *>(h); }

int ptn_num_spheres(void *h) {
  return static_cast<int>(static_cast<Builder *>(h)->sph_mat.size());
}
int ptn_num_triangles(void *h) {
  return static_cast<int>(static_cast<Builder *>(h)->tri_mat.size());
}
int ptn_num_materials(void *h) {
  return static_cast<int>(static_cast<Builder *>(h)->mats.size());
}
int ptn_num_area_lights(void *h) {
  return static_cast<int>(static_cast<Builder *>(h)->al_tri0.size());
}
int ptn_num_point_lights(void *h) {
  return static_cast<int>(static_cast<Builder *>(h)->pl.size() / 6);
}

// copies into caller-allocated buffers
void ptn_get_spheres(void *h, float *xyzr, int *mat) {
  auto *b = static_cast<Builder *>(h);
  std::memcpy(xyzr, b->sph.data(), b->sph.size() * sizeof(float));
  std::memcpy(mat, b->sph_mat.data(), b->sph_mat.size() * sizeof(int));
}

void ptn_get_triangles(void *h, float *v18, int *mat) {
  auto *b = static_cast<Builder *>(h);
  std::memcpy(v18, b->tri.data(), b->tri.size() * sizeof(float));
  std::memcpy(mat, b->tri_mat.data(), b->tri_mat.size() * sizeof(int));
}

// 21 floats + flags int per material: diffuse3 specular3 absorption3
// emission3 specExp ior diffAvg specAvg refrAvg roughness
void ptn_get_materials(void *h, float *f21, int *flags) {
  auto *b = static_cast<Builder *>(h);
  for (size_t i = 0; i < b->mats.size(); i++) {
    const Material &m = b->mats[i];
    float *o = f21 + i * 21;
    std::memcpy(o, m.diffuse, 3 * sizeof(float));
    std::memcpy(o + 3, m.specular, 3 * sizeof(float));
    std::memcpy(o + 6, m.absorption, 3 * sizeof(float));
    std::memcpy(o + 9, m.emission, 3 * sizeof(float));
    o[12] = m.spec_exp;
    o[13] = m.ior;
    o[14] = m.diff_avg;
    o[15] = m.spec_avg;
    o[16] = m.refr_avg;
    o[17] = m.roughness;
    o[18] = o[19] = o[20] = 0;
    flags[i] = m.flags;
  }
}

void ptn_get_point_lights(void *h, float *pos_power6) {
  auto *b = static_cast<Builder *>(h);
  std::memcpy(pos_power6, b->pl.data(), b->pl.size() * sizeof(float));
}

void ptn_get_area_lights(void *h, float *power3, float *area, int *tri0) {
  auto *b = static_cast<Builder *>(h);
  std::memcpy(power3, b->al_power.data(), b->al_power.size() * sizeof(float));
  std::memcpy(area, b->al_area.data(), b->al_area.size() * sizeof(float));
  std::memcpy(tri0, b->al_tri0.data(), b->al_tri0.size() * sizeof(int));
}

}  // extern "C"
