// Native host-side I/O runtime of the port: YUV420 stream reader with a
// background prefetch thread and fused YUV<->RGB conversion loops (a copy of
// memcnet_tpu/native/yuv_native.cpp: the port builds and loads its own).
//
// The device compute is CUDA (csrc/); this C++ module owns the host data
// path of the HD720p demo (the reference's yuv_frame_io.py:32-181), bound
// via ctypes (memcnet_tpu_torch/native/__init__.py).  Semantics mirror
// memcnet_tpu_torch/data/yuv.py (skimage rgb2yuv matrix, nearest x2 chroma
// upsample, truncating uint8 casts), whose numpy implementation is the test
// oracle.
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 (native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// skimage.color.rgb2yuv matrix (metrics/quality.py) and its inverse.
static const double M[3][3] = {
    {0.299, 0.587, 0.114},
    {-0.14714119, -0.28886916, 0.43601035},
    {0.61497538, -0.51496512, -0.10001026},
};
static const double MI[3][3] = {
    {1.0000000000000002e+00, -4.1827796340756807e-09, 1.1398830297637945e+00},
    {1.0000000000000000e+00, -3.9464233394412879e-01, -5.8062184967618791e-01},
    {1.0000000000000002e+00, 2.0320618532969705e+00, -1.2232657771803205e-09},
};

static inline uint8_t clip_trunc_u8(double v01) {
  // matches np.clip(v, 0, 1) * 255 then astype(uint8) truncation
  double v = v01 < 0.0 ? 0.0 : (v01 > 1.0 ? 1.0 : v01);
  return (uint8_t)(255.0 * v);
}

// YUV420 planar frame (row-major planes) -> uint8 RGB HWC, nearest x2 chroma
// upsample (yuv_frame_io.py:69-70 semantics).
void yuv420_to_rgb(const uint8_t* yp, const uint8_t* up, const uint8_t* vp,
                   int64_t h, int64_t w, uint8_t* rgb) {
  const int64_t cw = w / 2;
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t* yrow = yp + r * w;
    const uint8_t* urow = up + (r / 2) * cw;
    const uint8_t* vrow = vp + (r / 2) * cw;
    uint8_t* out = rgb + r * w * 3;
    for (int64_t c = 0; c < w; ++c) {
      const double y = yrow[c] / 255.0;
      const double u = urow[c / 2] / 255.0 - 0.5;
      const double v = vrow[c / 2] / 255.0 - 0.5;
      out[3 * c + 0] = clip_trunc_u8(MI[0][0] * y + MI[0][1] * u + MI[0][2] * v);
      out[3 * c + 1] = clip_trunc_u8(MI[1][0] * y + MI[1][1] * u + MI[1][2] * v);
      out[3 * c + 2] = clip_trunc_u8(MI[2][0] * y + MI[2][1] * u + MI[2][2] * v);
    }
  }
}

// uint8 RGB HWC -> YUV420 planar with 2x chroma decimation (top-left sample,
// yuv.py:68-69 `[::2, ::2]`).  Y is NOT clipped (rgb in [0,1] keeps y in
// [0,1] exactly as in yuv.py:67-70); U/V are offset +0.5 then clipped.
void rgb_to_yuv420(const uint8_t* rgb, int64_t h, int64_t w, uint8_t* yp,
                   uint8_t* up, uint8_t* vp) {
  const int64_t cw = w / 2;
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t* in = rgb + r * w * 3;
    uint8_t* yrow = yp + r * w;
    for (int64_t c = 0; c < w; ++c) {
      const double R = in[3 * c + 0] / 255.0;
      const double G = in[3 * c + 1] / 255.0;
      const double B = in[3 * c + 2] / 255.0;
      const double y = M[0][0] * R + M[0][1] * G + M[0][2] * B;
      yrow[c] = (uint8_t)(255.0 * y);
      if ((r % 2 == 0) && (c % 2 == 0)) {
        const double u = M[1][0] * R + M[1][1] * G + M[1][2] * B + 0.5;
        const double v = M[2][0] * R + M[2][1] * G + M[2][2] * B + 0.5;
        up[(r / 2) * cw + c / 2] = clip_trunc_u8(u);
        vp[(r / 2) * cw + c / 2] = clip_trunc_u8(v);
      }
    }
  }
}

// uint8 RGB HWC -> uint8 Y plane (demo_HD720p.py:152-160 protocol).
void rgb_to_y(const uint8_t* rgb, int64_t h, int64_t w, uint8_t* yp) {
  for (int64_t i = 0; i < h * w; ++i) {
    const double R = rgb[3 * i + 0] / 255.0;
    const double G = rgb[3 * i + 1] / 255.0;
    const double B = rgb[3 * i + 2] / 255.0;
    yp[i] = (uint8_t)(255.0 * (M[0][0] * R + M[0][1] * G + M[0][2] * B));
  }
}

// ---------------------------------------------------------------------------
// Prefetching YUV420 stream reader.
//
// A background thread keeps a small ring of upcoming raw frames resident
// (sequential GOP access is the demo_HD720p pattern, stride 2); reads are
// pread-based so random access needs no seek state.  The convert step runs
// on the caller's thread (ctypes releases the GIL for the whole call).

struct YuvReader {
  int fd = -1;
  int64_t h = 0, w = 0;
  int64_t frame_len = 0;   // 1.5 * h * w
  int64_t n_frames = 0;

  // prefetch ring
  static const int RING = 4;
  std::vector<uint8_t> ring_buf;             // RING * frame_len
  int64_t ring_frame[RING];                  // frame index or -1
  bool ring_ok[RING];
  int64_t want = -1;                         // next frame the worker fetches
  bool stop = false;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;

  bool fetch_into(int64_t frame, uint8_t* dst) const {
    if (frame < 0 || frame >= n_frames) return false;
    int64_t off = frame * frame_len;
    int64_t got = 0;
    while (got < frame_len) {
      ssize_t k = pread(fd, dst + got, frame_len - got, off + got);
      if (k <= 0) return false;
      got += k;
    }
    return true;
  }
};

static void reader_worker(YuvReader* rd) {
  std::unique_lock<std::mutex> lk(rd->mu);
  while (!rd->stop) {
    int64_t f = rd->want;
    int slot = f >= 0 ? (int)(f % YuvReader::RING) : -1;
    if (f < 0 || f >= rd->n_frames ||
        (rd->ring_frame[slot] == f && rd->ring_ok[slot])) {
      rd->cv.wait(lk);
      continue;
    }
    rd->ring_frame[slot] = f;
    rd->ring_ok[slot] = false;
    lk.unlock();
    uint8_t* dst = rd->ring_buf.data() + (int64_t)slot * rd->frame_len;
    bool ok = rd->fetch_into(f, dst);
    lk.lock();
    if (rd->ring_frame[slot] == f) rd->ring_ok[slot] = ok;
    rd->cv.notify_all();
  }
}

void* yuv_reader_open(const char* path, int64_t h, int64_t w) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  YuvReader* rd = new YuvReader();
  rd->fd = fd;
  rd->h = h;
  rd->w = w;
  rd->frame_len = h * w + 2 * ((h / 2) * (w / 2));
  rd->n_frames = st.st_size / rd->frame_len;
  rd->ring_buf.resize((int64_t)YuvReader::RING * rd->frame_len);
  for (int i = 0; i < YuvReader::RING; ++i) {
    rd->ring_frame[i] = -1;
    rd->ring_ok[i] = false;
  }
  rd->worker = std::thread(reader_worker, rd);
  return rd;
}

int64_t yuv_reader_num_frames(void* h) {
  return h ? ((YuvReader*)h)->n_frames : 0;
}

// Ask the worker to stage `frame` (non-blocking).
void yuv_reader_prefetch(void* h, int64_t frame) {
  YuvReader* rd = (YuvReader*)h;
  if (!rd) return;
  std::lock_guard<std::mutex> lk(rd->mu);
  rd->want = frame;
  rd->cv.notify_all();
}

// Read frame -> RGB (uint8 HWC).  Uses the prefetch ring when the frame is
// staged; kicks off a prefetch of frame+stride before converting so the next
// read overlaps this conversion.  Returns 1 on success, 0 on EOF/error.
int yuv_reader_read_rgb(void* h, int64_t frame, int64_t stride, uint8_t* rgb) {
  YuvReader* rd = (YuvReader*)h;
  if (!rd || frame < 0 || frame >= rd->n_frames) return 0;
  const int slot = (int)(frame % YuvReader::RING);
  std::vector<uint8_t> local;
  const uint8_t* raw = nullptr;
  {
    std::unique_lock<std::mutex> lk(rd->mu);
    if (rd->ring_frame[slot] == frame) {
      while (!rd->ring_ok[slot] && rd->ring_frame[slot] == frame)
        rd->cv.wait(lk);
      if (rd->ring_frame[slot] == frame && rd->ring_ok[slot]) {
        // copy out under the lock so the worker can't recycle the slot
        local.assign(
            rd->ring_buf.begin() + (int64_t)slot * rd->frame_len,
            rd->ring_buf.begin() + (int64_t)(slot + 1) * rd->frame_len);
        raw = local.data();
      }
    }
    rd->want = frame + stride;  // stage the next frame
    rd->cv.notify_all();
  }
  if (!raw) {
    local.resize(rd->frame_len);
    if (!rd->fetch_into(frame, local.data())) return 0;
    raw = local.data();
  }
  const uint8_t* yp = raw;
  const uint8_t* up = raw + rd->h * rd->w;
  const uint8_t* vp = up + (rd->h / 2) * (rd->w / 2);
  yuv420_to_rgb(yp, up, vp, rd->h, rd->w, rgb);
  return 1;
}

void yuv_reader_close(void* h) {
  YuvReader* rd = (YuvReader*)h;
  if (!rd) return;
  {
    std::lock_guard<std::mutex> lk(rd->mu);
    rd->stop = true;
    rd->cv.notify_all();
  }
  rd->worker.join();
  close(rd->fd);
  delete rd;
}

}  // extern "C"
