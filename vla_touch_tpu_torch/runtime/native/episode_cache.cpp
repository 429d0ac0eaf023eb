// episode_cache: the native episode cache of the port (counterpart of
// vla_touch_tpu/runtime/native/episode_cache.cpp, the same file format).
//
// Episodes are packed once into a flat binary cache (.epc) of fixed-size
// numeric records plus camera frames (JPEG or raw RGB) with an offset
// table; this library mmaps the cache and serves numeric windows and frames
// decoded on its own threads, so the Python layer holds the GIL only to
// hand out numpy arrays.  JPEG frames are decoded here with libjpeg where
// the build found it (EC_HAVE_LIBJPEG), or on the card by nvJPEG
// (csrc/jpeg_decode.cu) from the blob pointers ec_frame_blobs returns.
//
// File layout (little-endian), version 2 ('EPC2'; v1 'EPC1' still readable):
//   header:   magic 'EPC2' | u32 T | u32 n_cams | u32 H | u32 W
//             | u32 state_dim | u32 force_dim | u32 disp_dim
//             | u32 chunk (vla) | u32 has_vla
//             | u32 lang_len | u32 lang_dim | u32 codec | u32 has_raw_pose
//   qpos:     T * state_dim f32
//   forces:   T * force_dim f32
//   disps:    T * disp_dim  f32
//   vla:      T * chunk * state_dim f32           (if has_vla)
//   ee_poses: T * 7 f64                           (if has_raw_pose)
//   gripper:  T f64                               (if has_raw_pose)
//   lang:     lang_len * lang_dim f32             (precomputed T5 embedding)
//   offsets:  n_cams * (T+1) u64   (byte offsets of frame blobs)
//   blobs:    concatenated frame bytes (codec 0 = JPEG, 1 = raw RGB H*W*3)
//
// v2 carries the language embedding (a complete UnifiedVLADataset source),
// the raw f64 poses (qpos is derived in f64 from them, as from an h5 file)
// and the raw-frame codec (lossless: a memcpy out of the mmap, no decode).
//
// C API (ctypes-friendly): all functions return 0 on success.
// ec_decode_frames returns EC_NO_LIBJPEG on a JPEG cache when the build has
// no libjpeg: such frames decode on the card, never through another codec.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <thread>
#include <vector>
#include <atomic>

#ifdef EC_HAVE_LIBJPEG
#include <jpeglib.h>
#include <setjmp.h>
#endif

#define EC_NO_LIBJPEG 4

namespace {

struct HeaderV1 {
  char magic[4];
  uint32_t T, n_cams, H, W;
  uint32_t state_dim, force_dim, disp_dim;
  uint32_t chunk, has_vla;
};

struct Header {
  char magic[4];
  uint32_t T, n_cams, H, W;
  uint32_t state_dim, force_dim, disp_dim;
  uint32_t chunk, has_vla;
  uint32_t lang_len, lang_dim, codec, has_raw_pose;
};

struct Cache {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  Header hdr{};
  const float* qpos = nullptr;
  const float* forces = nullptr;
  const float* disps = nullptr;
  const float* vla = nullptr;
  const uint8_t* ee_poses = nullptr;  // f64, may be unaligned -> memcpy out
  const uint8_t* gripper = nullptr;   // f64
  const float* lang = nullptr;
  // Offsets are memcpy'd out of the mmap at open time: the table's file
  // position is only 4-byte aligned when the forces section is 12*T bytes,
  // and dereferencing a misaligned uint64_t* is UB.
  std::vector<uint64_t> offsets;      // n_cams * (T+1)
  const uint8_t* blobs = nullptr;
};

#ifdef EC_HAVE_LIBJPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode one JPEG blob into an RGB uint8 buffer of exactly H*W*3.
int decode_one(const uint8_t* data, size_t len, uint8_t* out, uint32_t H,
               uint32_t W) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_width != W || cinfo.output_height != H ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + size_t(cinfo.output_scanline) * W * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}
#endif  // EC_HAVE_LIBJPEG

}  // namespace

extern "C" {

void* ec_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) { ::close(fd); return nullptr; }

  auto* c = new Cache();
  c->fd = fd;
  c->base = static_cast<const uint8_t*>(base);
  c->size = st.st_size;
  size_t hdr_size;
  if (std::memcmp(c->base, "EPC2", 4) == 0) {
    std::memcpy(&c->hdr, c->base, sizeof(Header));
    hdr_size = sizeof(Header);
  } else if (std::memcmp(c->base, "EPC1", 4) == 0) {
    HeaderV1 h1;
    std::memcpy(&h1, c->base, sizeof(HeaderV1));
    std::memset(&c->hdr, 0, sizeof(Header));
    std::memcpy(&c->hdr, &h1, sizeof(HeaderV1));  // v2 extras stay 0
    hdr_size = sizeof(HeaderV1);
  } else {
    munmap(base, st.st_size); ::close(fd); delete c; return nullptr;
  }
  const Header& h = c->hdr;
  const uint8_t* p = c->base + hdr_size;
  c->qpos = reinterpret_cast<const float*>(p);
  p += size_t(h.T) * h.state_dim * 4;
  c->forces = reinterpret_cast<const float*>(p);
  p += size_t(h.T) * h.force_dim * 4;
  c->disps = reinterpret_cast<const float*>(p);
  p += size_t(h.T) * h.disp_dim * 4;
  if (h.has_vla) {
    c->vla = reinterpret_cast<const float*>(p);
    p += size_t(h.T) * h.chunk * h.state_dim * 4;
  }
  if (h.has_raw_pose) {
    c->ee_poses = p;                      // f64, possibly 4-aligned only
    p += size_t(h.T) * 7 * 8;
    c->gripper = p;
    p += size_t(h.T) * 8;
  }
  if (h.lang_len) {
    c->lang = reinterpret_cast<const float*>(p);
    p += size_t(h.lang_len) * h.lang_dim * 4;
  }
  size_t n_offsets = size_t(h.n_cams) * (h.T + 1);
  c->offsets.resize(n_offsets);
  std::memcpy(c->offsets.data(), p, n_offsets * 8);
  p += n_offsets * 8;
  c->blobs = p;
  return c;
}

void ec_close(void* handle) {
  auto* c = static_cast<Cache*>(handle);
  if (!c) return;
  munmap(const_cast<uint8_t*>(c->base), c->size);
  ::close(c->fd);
  delete c;
}

int ec_info(void* handle,
            uint32_t* out /* T,n_cams,H,W,state,force,disp,chunk,has_vla,
                             lang_len,lang_dim,codec,has_raw_pose */) {
  auto* c = static_cast<Cache*>(handle);
  if (!c) return 1;
  const Header& h = c->hdr;
  uint32_t v[13] = {h.T, h.n_cams, h.H, h.W, h.state_dim, h.force_dim,
                    h.disp_dim, h.chunk, h.has_vla,
                    h.lang_len, h.lang_dim, h.codec, h.has_raw_pose};
  std::memcpy(out, v, sizeof(v));
  return 0;
}

// Copy the precomputed language embedding (lang_len * lang_dim f32).
int ec_read_lang(void* handle, float* out) {
  auto* c = static_cast<Cache*>(handle);
  if (!c || !c->lang) return 1;
  std::memcpy(out, c->lang,
              size_t(c->hdr.lang_len) * c->hdr.lang_dim * 4);
  return 0;
}

// Copy the raw f64 pose sections: ee (T*7), gripper (T).  Either output
// may be null to skip.
int ec_read_raw_pose(void* handle, double* out_ee, double* out_grip) {
  auto* c = static_cast<Cache*>(handle);
  if (!c || !c->ee_poses) return 1;
  if (out_ee)
    std::memcpy(out_ee, c->ee_poses, size_t(c->hdr.T) * 7 * 8);
  if (out_grip)
    std::memcpy(out_grip, c->gripper, size_t(c->hdr.T) * 8);
  return 0;
}

// Copy numeric windows [start, start+count) into caller buffers (any may be
// null to skip).  vla_at: if >= 0, copy the (chunk, state_dim) vla record of
// that single timestep into out_vla.
int ec_read_window(void* handle, uint32_t start, uint32_t count,
                   float* out_qpos, float* out_force, float* out_disp,
                   int64_t vla_at, float* out_vla) {
  auto* c = static_cast<Cache*>(handle);
  if (!c) return 1;
  const Header& h = c->hdr;
  if (start + count > h.T) return 2;
  if (out_qpos)
    std::memcpy(out_qpos, c->qpos + size_t(start) * h.state_dim,
                size_t(count) * h.state_dim * 4);
  if (out_force)
    std::memcpy(out_force, c->forces + size_t(start) * h.force_dim,
                size_t(count) * h.force_dim * 4);
  if (out_disp)
    std::memcpy(out_disp, c->disps + size_t(start) * h.disp_dim,
                size_t(count) * h.disp_dim * 4);
  if (vla_at >= 0 && out_vla) {
    if (!c->vla || vla_at >= h.T) return 3;
    std::memcpy(out_vla,
                c->vla + size_t(vla_at) * h.chunk * h.state_dim,
                size_t(h.chunk) * h.state_dim * 4);
  }
  return 0;
}

// Decode frames [start, start+count) of camera `cam` into out (count*H*W*3
// uint8), fanning out across `n_threads` workers.
int ec_decode_frames(void* handle, uint32_t cam, uint32_t start,
                     uint32_t count, uint8_t* out, int n_threads) {
  auto* c = static_cast<Cache*>(handle);
  if (!c) return 1;
  const Header& h = c->hdr;
  if (cam >= h.n_cams || start + count > h.T) return 2;
#ifndef EC_HAVE_LIBJPEG
  if (h.codec != 1) return EC_NO_LIBJPEG;
#endif
  const uint64_t* offs = c->offsets.data() + size_t(cam) * (h.T + 1);
  std::atomic<int> fail{0};
  std::atomic<uint32_t> next{0};
  const size_t frame_bytes = size_t(h.H) * h.W * 3;

  auto worker = [&]() {
    for (;;) {
      uint32_t i = next.fetch_add(1);
      if (i >= count) break;
      uint32_t t = start + i;
      const uint8_t* blob = c->blobs + offs[t];
      size_t len = offs[t + 1] - offs[t];
      if (h.codec == 1) {  // raw RGB: lossless, mmap'd memcpy
        if (len != frame_bytes) { fail.store(1); continue; }
        std::memcpy(out + size_t(i) * frame_bytes, blob, frame_bytes);
      }
#ifdef EC_HAVE_LIBJPEG
      else if (decode_one(blob, len, out + size_t(i) * frame_bytes, h.H, h.W)) {
        fail.store(1);
      }
#endif
    }
  };

  int nt = n_threads < 1 ? 1 : n_threads;
  if (nt == 1 || count <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int k = 0; k < nt; ++k) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return fail.load();
}

// Pointers into the mmap and byte lengths of the blobs of frames
// [start, start+count) of camera `cam`: the compressed frames handed to the
// card's decoder.  They stay valid until ec_close.
int ec_frame_blobs(void* handle, uint32_t cam, uint32_t start, uint32_t count,
                   const uint8_t** out_ptrs, uint64_t* out_lens) {
  auto* c = static_cast<Cache*>(handle);
  if (!c) return 1;
  const Header& h = c->hdr;
  if (cam >= h.n_cams || start + count > h.T) return 2;
  const uint64_t* offs = c->offsets.data() + size_t(cam) * (h.T + 1);
  for (uint32_t i = 0; i < count; ++i) {
    out_ptrs[i] = c->blobs + offs[start + i];
    out_lens[i] = offs[start + i + 1] - offs[start + i];
  }
  return 0;
}

// 1 if this build decodes JPEG on the host (libjpeg), else 0.
int ec_have_libjpeg() {
#ifdef EC_HAVE_LIBJPEG
  return 1;
#else
  return 0;
#endif
}

}  // extern "C"
