// Native NIfTI-1 reader + multithreaded patch extractor (the PyTorch port's copy).
//
// The reference's host data path is SimpleITK (C++) behind Python wrappers
// (reference utils/NiftiDataset.py:402). This is the framework's native
// equivalent: zlib-inflating NIfTI reader that decodes straight into a
// float32 buffer (dtype conversion + scl_slope/inter fused into the decode
// loop), and a std::thread patch-gather used by the training loader to cut
// host-side patch-extraction latency.
//
// C ABI, consumed from Python via ctypes (mra_gan_tpu_torch/data/native.py).
// Built at first use by mra_gan_tpu_torch/data/native.py into build/native/
// (g++ -O3 -march=native -ffp-contract=off -std=c++17 -shared -fPIC ... -lz
// -lpthread). -ffp-contract=off keeps s * slope + inter two roundings, as the
// pure-Python reader (data/nifti.py) computes it.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

struct NiftiInfo {
  int64_t dims[8];      // [ndim, d1..d7]
  int32_t datatype;
  float pixdim[8];
  float scl_slope;
  float scl_inter;
  float srow[12];       // sform rows (valid if sform_code > 0)
  int32_t sform_code;
  int32_t qform_code;
  float quatern[6];     // b c d qx qy qz
};

// ---------------------------------------------------------------------------
// file reading: gzread reads .nii.gz and, transparently, plain .nii alike.
// The header is read first and the voxels then straight into their
// destination (the float32 output itself for float32 data), so a volume is
// neither held twice nor grown by reallocation.

static bool read_exact(gzFile f, void* dst, size_t n) {
  unsigned char* p = static_cast<unsigned char*>(dst);
  while (n > 0) {
    unsigned step = n > (1u << 30) ? (1u << 30) : static_cast<unsigned>(n);
    int got = gzread(f, p, step);
    if (got <= 0) return false;
    p += got;
    n -= static_cast<size_t>(got);
  }
  return true;
}

static size_t type_size(int16_t datatype) {
  switch (datatype) {
    case 2: case 256: return 1;
    case 4: case 512: return 2;
    case 8: case 16: case 768: return 4;
    case 64: return 8;
    default: return 0;
  }
}

template <typename T>
static void convert(const unsigned char* src, float* dst, int64_t count,
                    float slope, float inter) {
  const T* s = reinterpret_cast<const T*>(src);
  if (slope == 1.0f && inter == 0.0f) {
    for (int64_t i = 0; i < count; ++i) dst[i] = static_cast<float>(s[i]);
  } else {
    for (int64_t i = 0; i < count; ++i)
      dst[i] = static_cast<float>(s[i]) * slope + inter;
  }
}

static int read_nifti(gzFile f, NiftiInfo* info, float** out) {
  unsigned char h[348];
  if (!read_exact(f, h, sizeof(h))) return 1;
  int32_t sizeof_hdr;
  memcpy(&sizeof_hdr, h, 4);
  if (sizeof_hdr != 348) return 2;  // big-endian unsupported in fast path
  if (!(memcmp(h + 344, "n+1", 3) == 0 || memcmp(h + 344, "ni1", 3) == 0)) return 3;

  int16_t dim[8];
  memcpy(dim, h + 40, 16);
  int16_t datatype;
  memcpy(&datatype, h + 70, 2);
  float pixdim[8];
  memcpy(pixdim, h + 76, 32);
  float vox_offset, scl_slope, scl_inter;
  memcpy(&vox_offset, h + 108, 4);
  memcpy(&scl_slope, h + 112, 4);
  memcpy(&scl_inter, h + 116, 4);
  int16_t qform_code, sform_code;
  memcpy(&qform_code, h + 252, 2);
  memcpy(&sform_code, h + 254, 2);

  info->dims[0] = dim[0];
  int64_t count = 1;
  for (int i = 1; i < 8; ++i) {
    info->dims[i] = dim[i] > 0 ? dim[i] : 1;
    if (i <= dim[0]) count *= info->dims[i];
  }
  info->datatype = datatype;
  memcpy(info->pixdim, pixdim, 32);
  info->scl_slope = (scl_slope == 0.0f) ? 1.0f : scl_slope;
  info->scl_inter = scl_inter;
  info->sform_code = sform_code;
  info->qform_code = qform_code;
  memcpy(info->srow, h + 280, 48);
  memcpy(info->quatern, h + 256, 24);

  size_t elem = type_size(datatype);
  if (elem == 0) return 6;
  size_t off = static_cast<size_t>(vox_offset);
  if (off < sizeof(h) || gzseek(f, static_cast<z_off_t>(off), SEEK_SET) < 0) return 4;
  size_t need = static_cast<size_t>(count) * elem;

  float* buf = static_cast<float*>(malloc(sizeof(float) * count));
  if (!buf) return 5;
  float sl = info->scl_slope, in = info->scl_inter;
  if (datatype == 16) {  // float32: read in place, then scale in place
    if (!read_exact(f, buf, need)) { free(buf); return 4; }
    if (sl != 1.0f || in != 0.0f) convert<float>(reinterpret_cast<unsigned char*>(buf), buf,
                                                 count, sl, in);
    *out = buf;
    return 0;
  }
  unsigned char* raw = static_cast<unsigned char*>(malloc(need));
  if (!raw) { free(buf); return 5; }
  if (!read_exact(f, raw, need)) { free(raw); free(buf); return 4; }
  switch (datatype) {
    case 2:    convert<uint8_t>(raw, buf, count, sl, in); break;
    case 4:    convert<int16_t>(raw, buf, count, sl, in); break;
    case 8:    convert<int32_t>(raw, buf, count, sl, in); break;
    case 64:   convert<double>(raw, buf, count, sl, in); break;
    case 256:  convert<int8_t>(raw, buf, count, sl, in); break;
    case 512:  convert<uint16_t>(raw, buf, count, sl, in); break;
    case 768:  convert<uint32_t>(raw, buf, count, sl, in); break;
  }
  free(raw);
  *out = buf;
  return 0;
}

extern "C" {

// Reads header into *info and voxels (converted to float32, Fortran order as
// stored) into a malloc'd buffer returned through *out. Returns 0 on success.
int nifti_read(const char* path, NiftiInfo* info, float** out) {
  gzFile f = gzopen(path, "rb");
  if (!f) return 1;
  gzbuffer(f, 1 << 20);
  int rc = read_nifti(f, info, out);
  gzclose(f);
  return rc;
}

void nifti_free(float* p) { free(p); }

// ---------------------------------------------------------------------------
// patch extraction
//
// vol: C-order (d0, d1, d2) float32; starts: (n, 3); out: (n, p0, p1, p2).
// Threads split the patch list.

void extract_patches(const float* vol, int64_t d0, int64_t d1, int64_t d2,
                     const int64_t* starts, int64_t n,
                     int64_t p0, int64_t p1, int64_t p2,
                     float* out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t s0 = starts[i * 3], s1 = starts[i * 3 + 1], s2 = starts[i * 3 + 2];
      float* dst = out + i * p0 * p1 * p2;
      for (int64_t a = 0; a < p0; ++a) {
        for (int64_t b = 0; b < p1; ++b) {
          const float* src = vol + ((s0 + a) * d1 + (s1 + b)) * d2 + s2;
          memcpy(dst + (a * p1 + b) * p2, src, sizeof(float) * p2);
        }
      }
    }
  };
  if (n_threads == 1 || n < 2) {
    worker(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * per, hi = lo + per > n ? n : lo + per;
    if (lo >= hi) break;
    ts.emplace_back(worker, lo, hi);
  }
  for (auto& t : ts) t.join();
}

}  // extern "C"
