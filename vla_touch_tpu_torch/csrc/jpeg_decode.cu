// Batched JPEG decode on the card with nvJPEG (the CUDA toolkit's library):
// the episode cache's codec-0 frames (runtime/native_loader.py) into
// (count, H, W, 3) uint8 RGB in device memory.
//
// Replaces no TPU kernel.  The JAX package decodes a .epc cache's JPEG
// frames on the host with libjpeg (vla_touch_tpu/runtime/native/
// episode_cache.cpp); the card's host has no jpeglib.h, and the decoded
// frames are bound for the card anyway, so they decode there.  The work is
// Huffman decoding (serial within a frame; nvJPEG's batched decoder splits
// it between host threads and the card by size), then the inverse DCT,
// chroma upsampling and colour conversion on the card: bound by the
// compressed bytes' entropy decode, not by device memory (a 480 x 640 frame
// writes 0.9 MB).  The design hands nvJPEG the whole batch in one
// nvjpegDecodeBatched call on the caller's stream.  Each host thread keeps
// one decoder state for its life (nvJPEG's device and pinned buffers are
// allocated once, not per call; a cudaFree would wait for the whole device)
// and re-initialises it only when the batch size changes.
//
// C interface for ctypes: vtt_jpeg_decode returns 0, a CUDA error code, or
// JPEG_STATUS_BASE + an nvjpegStatus_t; vtt_error_string names either.  The
// call waits for its stream (and only that stream) before it returns, so the
// output is ready and the blobs may be unmapped after it.

#include <cuda_runtime.h>
#include <nvjpeg.h>
#include <stdint.h>
#include <stdio.h>

#include <mutex>
#include <vector>

namespace {

constexpr int JPEG_STATUS_BASE = 1000;
constexpr int JPEG_WRONG_SHAPE = 2000;

nvjpegHandle_t g_handle = nullptr;
nvjpegStatus_t g_handle_status = NVJPEG_STATUS_SUCCESS;
std::once_flag g_once;

nvjpegHandle_t handle() {
  std::call_once(g_once, [] { g_handle_status = nvjpegCreateSimple(&g_handle); });
  return g_handle_status == NVJPEG_STATUS_SUCCESS ? g_handle : nullptr;
}

// A thread's batched decoder state, freed when the thread ends.
struct Decoder {
  nvjpegJpegState_t state = nullptr;
  int batch = 0;  // the batch size the state is initialised for; 0: none
  ~Decoder() {
    if (state) nvjpegJpegStateDestroy(state);
  }
};
thread_local Decoder t_decoder;

}  // namespace

extern "C" {

const char* vtt_error_string(int err) {
  static thread_local char buf[96];
  if (err == JPEG_WRONG_SHAPE) return "a JPEG frame is not H x W with 3 components";
  if (err >= JPEG_STATUS_BASE) {
    snprintf(buf, sizeof(buf), "nvjpegStatus_t %d", err - JPEG_STATUS_BASE);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// blobs[i], lens[i]: the compressed frames (host memory); out: count * H * W
// * 3 bytes of device memory, frame i at out + i * H * W * 3.
int vtt_jpeg_decode(const uint8_t* const* blobs, const size_t* lens, int count,
                    uint8_t* out, int H, int W, cudaStream_t stream) {
  if (count <= 0) return 0;
  nvjpegHandle_t h = handle();
  if (!h) return JPEG_STATUS_BASE + g_handle_status;
  for (int i = 0; i < count; ++i) {
    int comps = 0;
    nvjpegChromaSubsampling_t sub;
    int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
    nvjpegStatus_t s = nvjpegGetImageInfo(h, blobs[i], lens[i], &comps, &sub, widths, heights);
    if (s != NVJPEG_STATUS_SUCCESS) return JPEG_STATUS_BASE + s;
    if (comps != 3 || widths[0] != W || heights[0] != H) return JPEG_WRONG_SHAPE;
  }
  Decoder& d = t_decoder;
  nvjpegStatus_t s = NVJPEG_STATUS_SUCCESS;
  if (!d.state && (s = nvjpegJpegStateCreate(h, &d.state)) != NVJPEG_STATUS_SUCCESS) {
    d.state = nullptr;
    return JPEG_STATUS_BASE + s;
  }
  std::vector<nvjpegImage_t> dst(count);
  const size_t frame = size_t(H) * W * 3;
  for (int i = 0; i < count; ++i) {
    for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
      dst[i].channel[c] = nullptr;
      dst[i].pitch[c] = 0;
    }
    dst[i].channel[0] = out + size_t(i) * frame;   // interleaved RGB
    dst[i].pitch[0] = size_t(W) * 3;
  }
  if (d.batch != count) {
    d.batch = 0;
    s = nvjpegDecodeBatchedInitialize(h, d.state, count, 1, NVJPEG_OUTPUT_RGBI);
    if (s != NVJPEG_STATUS_SUCCESS) return JPEG_STATUS_BASE + s;
    d.batch = count;
  }
  s = nvjpegDecodeBatched(h, d.state, blobs, lens, dst.data(), stream);
  if (s != NVJPEG_STATUS_SUCCESS) {
    d.batch = 0;  // initialise afresh on the next call
    return JPEG_STATUS_BASE + s;
  }
  return cudaStreamSynchronize(stream);
}

}  // extern "C"
