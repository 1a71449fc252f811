// cliploader — native clip decoder and wire encoder of the laryngeal_tpu_torch
// host pipeline (the port's copy of the JAX package's native/cliploader.cpp;
// the same code, so the two builds give the same pixels and coefficients).
//
// The reference's host data path re-decodes videos through Python
// (pytorchvideo/PyAV or cv2 seek loops) every epoch; this library is the
// replacement: a single sequential libavcodec decode pass that
// gathers only the sampled frame indices, scales with swscale, and emits
// either RGB24 or packed I420 planes (the framework's half-size host->device
// wire format — no colorspace conversion at all when the source is already
// yuv420p, which every h264/mpeg4 laryngoscopy file is).
//
// C ABI (ctypes-friendly):
//   video_props(path, &total, &fps, &w, &h) -> 0 ok
//   clip_decode(path, indices, n, out_w, out_h, fmt, out, &decoded) -> 0 ok
//     fmt: 0 = RGB24 (n, out_h, out_w, 3), 1 = I420 (n, out_h*3/2, out_w)
//     indices must be non-decreasing; duplicates allowed (frame copied).
//   clip_decode_ex(..., flags, out, &decoded) — flags bit 0 = fast decode
//     (skip h264 loop filter; small bounded pixel drift, for lossy wires).
//
// Build: laryngeal_tpu_torch/data/native.py compiles it at first use with g++
// and pkg-config's libavformat/avcodec/avutil/swscale flags into
// laryngeal_tpu_torch/_build/.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Reader {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  int stream_index = -1;

  ~Reader() {
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
  }

  int open(const char* path, int fast = 0) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
    if (avformat_find_stream_info(fmt, nullptr) < 0) return -2;
    stream_index =
        av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
    if (stream_index < 0) return -3;
    AVStream* st = fmt->streams[stream_index];
    const AVCodec* codec = avcodec_find_decoder(st->codecpar->codec_id);
    if (!codec) return -4;
    dec = avcodec_alloc_context3(codec);
    if (!dec || avcodec_parameters_to_context(dec, st->codecpar) < 0) return -5;
    // Auto-size decoder threads to the host (frame+slice threading); on a
    // 1-core host this resolves to 1 thread with no overhead, on real
    // multi-core hosts it parallelizes the h264 decode that bounds the
    // end-to-end pipeline.
    dec->thread_count = 0;
    dec->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
    if (fast & 1) {
      // Fast-decode mode: skip the h264 in-loop deblocking filter (the
      // classic `ffmpeg -skip_loop_filter all` knob). Every frame is still
      // decoded and emitted — only the deblock pass is dropped, so output
      // pixels drift slightly from the spec decode (and the drift compounds
      // along inter-frame prediction chains within a GOP). Intended for the
      // lossy DCT wire, whose quantization already dominates this error;
      // measured drift/speed tradeoff lives in BASELINE.md.
      dec->skip_loop_filter = AVDISCARD_ALL;
    }
    int lowres = (fast >> 1) & 3;
    if (lowres > 0) {
      // Reduced-resolution decode (ffmpeg's `-lowres` knob): mpegvideo-
      // family decoders (mpeg4 max_lowres=3 in this libavcodec) run their
      // iDCT and motion compensation at 1/2^lowres scale, emitting
      // (w>>lowres, h>>lowres) frames for a fraction of the decode CPU.
      // Lossy by construction (a 4x4 partial iDCT is not a downscaled 8x8
      // decode) — same accounting regime as the lossy DCT wire; drift
      // pinned in BASELINE.md. avcodec_open2 clamps unsupported levels to
      // the codec's max_lowres (h264: 0) with a warning, so callers must
      // size out_w/out_h from the POST-open dec->lowres, which
      // clip_decode_ex re-checks.
      dec->lowres = lowres;
    }
    if (avcodec_open2(dec, codec, nullptr) < 0) return -6;
    if (lowres > 0 && dec->lowres != lowres) return -7;  // codec can't
    return 0;
  }

  AVStream* stream() const { return fmt->streams[stream_index]; }
};

double stream_fps(AVStream* st) {
  AVRational r = st->avg_frame_rate;
  if (r.num <= 0 || r.den <= 0) r = st->r_frame_rate;
  if (r.num <= 0 || r.den <= 0) return 30.0;
  return av_q2d(r);
}

}  // namespace

// ---------------------------------------------------------------------------
// DCT wire encoder — 8x8 JPEG-style transform+quantization of I420 planes.
//
// The host->device relay moves payloads with long byte runs dramatically
// faster (it content-compresses; BASELINE.md wire study). Quantized DCT
// coefficient planes are mostly zero runs, so this encoder turns a decoded
// I420 clip into the framework's "dct" wire format: per-clip DC plane
// (int16, (T, NB)) + AC planes (int8, (63, T, NB), coefficient-major so
// zeros are contiguous), with JPEG Annex-K tables scaled by `quality`.
// The exact inverse (dequant + IDCT + chroma expansion) runs on the device
// (laryngeal_tpu_torch/preprocess/dct_wire.py). Bounded, measured loss.
// ---------------------------------------------------------------------------

namespace {

const float kJpegLumaQ50[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const float kJpegChromaQ50[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Matches scripts' / dct_wire.py's quant_table: floor((base*scale+50)/100),
// clamped to [1, 255]; scale = 5000/q (q<50) else 200-2q.
void quant_recip(const float* base, int quality, float* recip) {
  float scale = quality < 50 ? 5000.0f / quality : 200.0f - 2.0f * quality;
  for (int i = 0; i < 64; ++i) {
    float t = std::floor((base[i] * scale + 50.0f) / 100.0f);
    if (t < 1.0f) t = 1.0f;
    if (t > 255.0f) t = 255.0f;
    recip[i] = 1.0f / t;
  }
}

struct DctBasis {
  float c[8][8];  // DCT-II matrix: X = C * x * C^T
  DctBasis() {
    const float pi = 3.14159265358979323846f;
    for (int k = 0; k < 8; ++k)
      for (int n = 0; n < 8; ++n) {
        float v = std::cos((2 * n + 1) * k * pi / 16.0f) * std::sqrt(2.0f / 8);
        if (k == 0) v *= 1.0f / std::sqrt(2.0f);
        c[k][n] = v;
      }
  }
};
const DctBasis kBasis;

// JPEG zigzag scan: kZigzag[i] = row-major coefficient index of frequency-
// order position i (AC planes ship in this order so truncation drops the
// highest frequencies; must match preprocess/dct_wire.py::ZIGZAG).
const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// One plane (ph x pw, row stride = pw) -> coefficients written into
// dc[t_off + b] / ac[(c-1)*ac_stride + t_off + b] for blocks b in
// [block_off, block_off + nblocks).
void dct_plane(const uint8_t* plane, int ph, int pw, const float* recip,
               int16_t* dc, int8_t* ac, size_t ac_stride, size_t t_off,
               size_t block_off, int keep_ac) {
  const int nbx = pw / 8;
  const int nby = ph / 8;
  float a[8][8], tmp[8][8], out[64];
  for (int by = 0; by < nby; ++by) {
    for (int bx = 0; bx < nbx; ++bx) {
      const uint8_t* src = plane + (size_t)by * 8 * pw + bx * 8;
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 8; ++j)
          a[i][j] = (float)src[(size_t)i * pw + j] - 128.0f;
      // tmp = a * C^T ; out = C * tmp. Broadcast-FMA form: the inner loop
      // runs over the 8-lane OUTPUT axis (one vector FMA per scalar
      // broadcast) instead of a scalar dot-product reduction.
      for (int i = 0; i < 8; ++i) {
        for (int k = 0; k < 8; ++k) tmp[i][k] = a[i][0] * kBasis.c[k][0];
        for (int j = 1; j < 8; ++j) {
          const float s = a[i][j];
          for (int k = 0; k < 8; ++k) tmp[i][k] += s * kBasis.c[k][j];
        }
      }
      for (int k = 0; k < 8; ++k) {
        const float c0 = kBasis.c[k][0];
        for (int l = 0; l < 8; ++l) out[k * 8 + l] = c0 * tmp[0][l];
        for (int i = 1; i < 8; ++i) {
          const float c = kBasis.c[k][i];
          for (int l = 0; l < 8; ++l) out[k * 8 + l] += c * tmp[i][l];
        }
      }
      const size_t b = block_off + (size_t)by * nbx + bx;
      // Quantize all 64 coefficients with vectorizable mul+round+clamp
      // passes; only the 63 zigzag-scattered byte stores stay scalar.
      float qf[64];
      int8_t qi[64];
      for (int c = 0; c < 64; ++c) qf[c] = std::nearbyint(out[c] * recip[c]);
      for (int c = 0; c < 64; ++c) {
        float q = qf[c];
        if (q > 127.0f) q = 127.0f;
        if (q < -128.0f) q = -128.0f;
        qi[c] = (int8_t)q;
      }
      dc[t_off + b] = (int16_t)qf[0];
      // Store only the kept zigzag planes: the default wire keeps 31/63, so
      // scattering all 63 would waste half the stores AND force the Python
      // side to slice+copy the truncated array afterwards.
      for (int p = 1; p < keep_ac + 1; ++p)  // AC planes in zigzag order
        ac[(size_t)(p - 1) * ac_stride + t_off + b] = qi[kZigzag[p]];
    }
  }
}

}  // namespace

extern "C" {

// I420 clip (n frames, h*3/2 x w) -> dct wire format.
//   dc_out : int16 (n, NB)           NB = (h/8)*(w/8) + 2*(h/16)*(w/16)
//   ac_out : int8  (63, n, NB)       coefficient-major (zero-run friendly)
// h, w must be multiples of 16. Returns 0 on success.
// ac_out must hold keep_ac planes: int8 (keep_ac, n, NB).
int clip_dct_encode_k(const uint8_t* i420, int n, int h, int w, int quality,
                      int keep_ac, int16_t* dc_out, int8_t* ac_out) {
  if (h % 16 || w % 16 || n <= 0) return -1;
  if (quality < 1 || quality > 100) return -2;
  if (keep_ac < 0 || keep_ac > 63) return -3;
  float ry[64], rc[64];
  quant_recip(kJpegLumaQ50, quality, ry);
  quant_recip(kJpegChromaQ50, quality, rc);
  const size_t nby = (size_t)(h / 8) * (w / 8);
  const size_t nbc = (size_t)(h / 16) * (w / 16);
  const size_t nb = nby + 2 * nbc;
  const size_t frame_bytes = (size_t)w * h * 3 / 2;
  const size_t ac_stride = (size_t)n * nb;
  for (int t = 0; t < n; ++t) {
    const uint8_t* f = i420 + (size_t)t * frame_bytes;
    const size_t t_off = (size_t)t * nb;
    dct_plane(f, h, w, ry, dc_out, ac_out, ac_stride, t_off, 0, keep_ac);
    dct_plane(f + (size_t)w * h, h / 2, w / 2, rc, dc_out, ac_out, ac_stride,
              t_off, nby, keep_ac);
    dct_plane(f + (size_t)w * h + (size_t)(w / 2) * (h / 2), h / 2, w / 2, rc,
              dc_out, ac_out, ac_stride, t_off, nby + nbc, keep_ac);
  }
  return 0;
}

int clip_dct_encode(const uint8_t* i420, int n, int h, int w, int quality,
                    int16_t* dc_out, int8_t* ac_out) {
  return clip_dct_encode_k(i420, n, h, w, quality, 63, dc_out, ac_out);
}

// Nibble-pack high-frequency AC planes: `ac` is (nplanes, elems) int8
// plane-major; pairs of consecutive planes are clamped to the signed 4-bit
// range [-8, 7] and packed low-nibble/high-nibble into one uint8 plane of
// `out` ((nplanes+1)/2, elems). An odd trailing plane pairs with an implicit
// zero plane. The host->device relay hashes/compresses the *raw* payload
// bytes on the single host core (BASELINE.md round-3 stall attribution), so
// halving the bytes of planes that are almost entirely in [-8,7] buys real
// end-to-end throughput at a measured, bounded clamp loss.
int ac_pack_nibble(const int8_t* ac, int nplanes, long long elems,
                   uint8_t* out) {
  if (nplanes < 0 || elems < 0) return -1;
  const int pairs = (nplanes + 1) / 2;
  for (int j = 0; j < pairs; ++j) {
    const int8_t* lo = ac + (size_t)(2 * j) * elems;
    const int8_t* hi =
        (2 * j + 1 < nplanes) ? ac + (size_t)(2 * j + 1) * elems : nullptr;
    uint8_t* dst = out + (size_t)j * elems;
    if (hi) {
      for (long long e = 0; e < elems; ++e) {
        int a = lo[e] < -8 ? -8 : (lo[e] > 7 ? 7 : lo[e]);
        int b = hi[e] < -8 ? -8 : (hi[e] > 7 ? 7 : hi[e]);
        dst[e] = (uint8_t)((a & 15) | ((b & 15) << 4));
      }
    } else {
      for (long long e = 0; e < elems; ++e) {
        int a = lo[e] < -8 ? -8 : (lo[e] > 7 ? 7 : lo[e]);
        dst[e] = (uint8_t)(a & 15);
      }
    }
  }
  return 0;
}

}  // extern "C"

extern "C" {

// ABI feature level of this build. 1 = clip_decode_ex carries only the
// fast-decode flag in bit 0; 2 = flags bits 1-2 additionally carry the
// lowres level. Callers must gate lowres on abi >= 2: a level-1 .so
// accepts the same call but ignores the bits and decodes at full
// resolution — a silent wrong-measurement, not an error.
int cliploader_abi(void) { return 2; }

int video_props(const char* path, int* total_frames, double* fps, int* width,
                int* height) {
  Reader r;
  int rc = r.open(path);
  if (rc != 0) return rc;
  AVStream* st = r.stream();
  *width = r.dec->width;
  *height = r.dec->height;
  *fps = stream_fps(st);
  int64_t n = st->nb_frames;
  if (n <= 0 && st->duration > 0) {
    n = (int64_t)(st->duration * av_q2d(st->time_base) * (*fps) + 0.5);
  }
  if (n <= 0 && r.fmt->duration > 0) {
    n = (int64_t)((double)r.fmt->duration / AV_TIME_BASE * (*fps) + 0.5);
  }
  *total_frames = (int)n;
  return 0;
}

// fmt: 0 = RGB24, 1 = I420 packed planes.
// flags bit 0: fast decode (skip the h264 loop filter; bounded pixel drift).
int clip_decode_ex(const char* path, const int* indices, int n_indices,
                   int out_w, int out_h, int fmt_code, int flags, uint8_t* out,
                   int* decoded_count) {
  if (n_indices <= 0) return -10;
  for (int i = 1; i < n_indices; ++i)
    if (indices[i] < indices[i - 1]) return -11;  // must be non-decreasing

  Reader r;
  int rc = r.open(path, flags);
  if (rc != 0) return rc;

  const AVPixelFormat dst_fmt =
      fmt_code == 1 ? AV_PIX_FMT_YUV420P : AV_PIX_FMT_RGB24;
  const size_t frame_bytes = fmt_code == 1
                                 ? (size_t)out_w * out_h * 3 / 2
                                 : (size_t)out_w * out_h * 3;

  AVFrame* frame = av_frame_alloc();
  AVFrame* scaled = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();
  scaled->format = dst_fmt;
  scaled->width = out_w;
  scaled->height = out_h;
  av_frame_get_buffer(scaled, 32);

  SwsContext* sws = nullptr;
  int cur = 0;      // index of the next frame the decoder will emit
  int want_i = 0;   // position in indices
  int filled = 0;
  const int last_needed = indices[n_indices - 1];

  auto emit = [&](AVFrame* f) {
    // Copy scaled frame into every output slot whose index == cur.
    while (want_i < n_indices && indices[want_i] == cur) {
      uint8_t* dst = out + (size_t)want_i * frame_bytes;
      if (fmt_code == 1) {
        uint8_t* p = dst;
        av_image_copy_plane(p, out_w, f->data[0], f->linesize[0], out_w, out_h);
        p += (size_t)out_w * out_h;
        av_image_copy_plane(p, out_w / 2, f->data[1], f->linesize[1], out_w / 2,
                            out_h / 2);
        p += (size_t)(out_w / 2) * (out_h / 2);
        av_image_copy_plane(p, out_w / 2, f->data[2], f->linesize[2], out_w / 2,
                            out_h / 2);
      } else {
        av_image_copy_plane(dst, out_w * 3, f->data[0], f->linesize[0],
                            out_w * 3, out_h);
      }
      ++want_i;
      ++filled;
    }
    ++cur;
  };

  auto handle_decoded = [&](AVFrame* f) {
    bool needed = want_i < n_indices && indices[want_i] == cur;
    if (needed) {
      // Identity fast path: when the decoder already emits the requested
      // geometry and format (common for 4:2:0 sources served at native
      // size), skip swscale entirely — emit() copies planes directly.
      if (f->width == out_w && f->height == out_h &&
          (AVPixelFormat)f->format == dst_fmt) {
        emit(f);
        return;
      }
      if (!sws) {
        sws = sws_getContext(f->width, f->height, (AVPixelFormat)f->format,
                             out_w, out_h, dst_fmt, SWS_BILINEAR, nullptr,
                             nullptr, nullptr);
      }
      sws_scale(sws, f->data, f->linesize, 0, f->height, scaled->data,
                scaled->linesize);
      emit(scaled);
    } else {
      ++cur;
    }
  };

  int err = 0;
  while (cur <= last_needed && av_read_frame(r.fmt, pkt) >= 0) {
    if (pkt->stream_index == r.stream_index) {
      // With frame threading (thread_count=0) the decoder can report
      // EAGAIN while worker threads hold finished frames; the packet must
      // then be RESENT after draining, not dropped — a dropped packet
      // would desync `cur` from the true frame index and silently
      // attribute wrong frames to every later request.
      for (;;) {
        int send_rc = avcodec_send_packet(r.dec, pkt);
        if (send_rc == 0) break;
        if (send_rc != AVERROR(EAGAIN)) {
          err = -20;  // fail fast; the Python wrapper falls back to cv2
          break;
        }
        // EAGAIN: drain at least one frame, then retry the same packet.
        if (avcodec_receive_frame(r.dec, frame) == 0) {
          handle_decoded(frame);
        } else {
          err = -21;  // decoder wedged: no output and no input accepted
          break;
        }
      }
      if (err != 0) {
        av_packet_unref(pkt);
        break;
      }
      while (avcodec_receive_frame(r.dec, frame) == 0) {
        handle_decoded(frame);
        if (cur > last_needed) break;
      }
    }
    av_packet_unref(pkt);
  }
  // Drain (skip after a hard packet error — the wrapper falls back).
  if (err == 0 && cur <= last_needed) {
    avcodec_send_packet(r.dec, nullptr);
    while (cur <= last_needed && avcodec_receive_frame(r.dec, frame) == 0) {
      handle_decoded(frame);
    }
  }

  *decoded_count = filled;
  if (sws) sws_freeContext(sws);
  av_frame_free(&frame);
  av_frame_free(&scaled);
  av_packet_free(&pkt);
  return err;
}

// Original ABI — exact (spec) decode.
int clip_decode(const char* path, const int* indices, int n_indices,
                int out_w, int out_h, int fmt_code, uint8_t* out,
                int* decoded_count) {
  return clip_decode_ex(path, indices, n_indices, out_w, out_h, fmt_code, 0,
                        out, decoded_count);
}

// H.264 encoder: RGB24 frames (n, h, w, 3) -> h264-in-mp4 at `path` via
// libx264 (crf rate control). The reference's codec preference is
// avc1/H264 first (src/yolo_detector.py:546-569) and its raw-filter mode
// re-encodes outputs with libx264 (src/yolo_detector.py:625-648); cv2 in
// this image has no h264 encoder, so this is the native path that makes
// both real. w and h must be even (yuv420p chroma subsampling).
// Returns 0 on success; 1 if libx264 is absent from libavcodec.
int clip_encode_h264(const char* path, const uint8_t* rgb, int n, int w,
                     int h, double fps, int crf, const char* preset) {
  if (n <= 0 || w <= 0 || h <= 0 || (w % 2) || (h % 2)) return -1;
  if (fps <= 0) fps = 30.0;
  const AVCodec* codec = avcodec_find_encoder_by_name("libx264");
  if (!codec) return 1;

  AVFormatContext* ofmt = nullptr;
  if (avformat_alloc_output_context2(&ofmt, nullptr, "mp4", path) < 0 || !ofmt)
    return -2;

  AVCodecContext* enc = avcodec_alloc_context3(codec);
  int err = 0;
  AVStream* st = nullptr;
  AVFrame* yuv = nullptr;
  AVPacket* pkt = nullptr;
  SwsContext* sws = nullptr;
  bool header_written = false;

  enc->width = w;
  enc->height = h;
  enc->pix_fmt = AV_PIX_FMT_YUV420P;
  // Exact rational fps (av_d2q on 1/fps loses precision: 1/30 -> 30.32
  // reported back); integer rates get {fps,1}, NTSC-style get a tight
  // rational.
  enc->framerate = av_d2q(fps, 100000);
  enc->time_base = av_inv_q(enc->framerate);
  if (ofmt->oformat->flags & AVFMT_GLOBALHEADER)
    enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  av_opt_set_int(enc->priv_data, "crf", crf < 0 ? 23 : crf, 0);
  av_opt_set(enc->priv_data, "preset", preset && *preset ? preset : "veryfast",
             0);

  auto write_packets = [&](bool flush) -> int {
    if (avcodec_send_frame(enc, flush ? nullptr : yuv) < 0) return -6;
    for (;;) {
      int rc = avcodec_receive_packet(enc, pkt);
      if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
      if (rc < 0) return -7;
      av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
      // One frame interval per packet: without an explicit duration the
      // mp4 muxer ends the stream at the last pts, shorting the container
      // by one interval (avg fps then reads n/(n-1) high).
      pkt->duration = av_rescale_q(1, enc->time_base, st->time_base);
      pkt->stream_index = st->index;
      rc = av_interleaved_write_frame(ofmt, pkt);
      av_packet_unref(pkt);
      if (rc < 0) return -8;
    }
  };

  if (avcodec_open2(enc, codec, nullptr) < 0) {
    err = -3;
    goto done;
  }
  st = avformat_new_stream(ofmt, nullptr);
  if (!st || avcodec_parameters_from_context(st->codecpar, enc) < 0) {
    err = -4;
    goto done;
  }
  st->time_base = enc->time_base;
  if (avio_open(&ofmt->pb, path, AVIO_FLAG_WRITE) < 0) {
    err = -5;
    goto done;
  }
  if (avformat_write_header(ofmt, nullptr) < 0) {
    err = -5;
    goto done;
  }
  header_written = true;

  yuv = av_frame_alloc();
  pkt = av_packet_alloc();
  yuv->format = AV_PIX_FMT_YUV420P;
  yuv->width = w;
  yuv->height = h;
  if (av_frame_get_buffer(yuv, 32) < 0) {
    err = -5;
    goto done;
  }
  sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h, AV_PIX_FMT_YUV420P,
                       SWS_BILINEAR, nullptr, nullptr, nullptr);
  if (!sws) {
    err = -5;
    goto done;
  }

  for (int t = 0; t < n && err == 0; ++t) {
    const uint8_t* src = rgb + (size_t)t * w * h * 3;
    const int stride = w * 3;
    av_frame_make_writable(yuv);
    sws_scale(sws, &src, &stride, 0, h, yuv->data, yuv->linesize);
    yuv->pts = t;
    err = write_packets(false);
  }
  if (err == 0) err = write_packets(true);  // flush the encoder
  if (header_written && av_write_trailer(ofmt) < 0 && err == 0) err = -9;

done:
  if (sws) sws_freeContext(sws);
  if (yuv) av_frame_free(&yuv);
  if (pkt) av_packet_free(&pkt);
  if (enc) avcodec_free_context(&enc);
  if (ofmt) {
    if (ofmt->pb) avio_closep(&ofmt->pb);
    avformat_free_context(ofmt);
  }
  return err;
}

}  // extern "C"
