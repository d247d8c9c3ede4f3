// Host-side audio decode for the TPU pipeline.
//
// Replaces the reference's dependency on ffmpeg-the-binary (via
// faster_whisper.decode_audio, reference diarize.py:125, and pydub,
// nemo_process.py:24) with an in-process libav decoder: any container or
// codec libavformat/libavcodec understands (opus/mp3/mp4/m4a/ogg/flac/
// webm/wav — the set enumerated at reference main.py:335-347) is decoded
// and resampled to mono float32 at the requested rate, ready to be copied
// into a device buffer.
//
// C ABI (consumed from Python via ctypes):
//   wnt_decode_audio(path, rate, &samples, &n, errbuf, errlen) -> 0 | <0
//   wnt_free(samples)
//   wnt_probe_duration(path, errbuf, errlen) -> seconds | <0

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

namespace {

// Keep libav's per-frame warning chatter (e.g. opus "Could not update
// timestamps for skipped samples") off the pipeline's stderr.
struct QuietLogInit {
  QuietLogInit() { av_log_set_level(AV_LOG_ERROR); }
} quiet_log_init;

void set_error(char* errbuf, int errlen, const std::string& msg) {
  if (errbuf && errlen > 0) {
    std::snprintf(errbuf, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

std::string av_err_str(int err) {
  char buf[AV_ERROR_MAX_STRING_SIZE] = {0};
  av_strerror(err, buf, sizeof(buf));
  return std::string(buf);
}

struct DecoderState {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* packet = nullptr;
  AVFrame* frame = nullptr;

  ~DecoderState() {
    if (frame) av_frame_free(&frame);
    if (packet) av_packet_free(&packet);
    if (swr) swr_free(&swr);
    if (codec) avcodec_free_context(&codec);
    if (fmt) avformat_close_input(&fmt);
  }
};

// Push one decoded frame through the resampler, appending mono f32
// samples to out.
int resample_frame(DecoderState& st, const AVFrame* frame, int out_rate,
                   std::vector<float>& out) {
  // Upper bound on output samples for this frame (+256 for swr delay).
  const int64_t in_samples = frame ? frame->nb_samples : 0;
  const int64_t in_rate = st.codec->sample_rate;
  const int max_out = static_cast<int>(
      av_rescale_rnd(swr_get_delay(st.swr, in_rate) + in_samples, out_rate,
                     in_rate, AV_ROUND_UP) +
      256);
  if (max_out <= 0) return 0;

  const size_t old_size = out.size();
  out.resize(old_size + static_cast<size_t>(max_out));
  uint8_t* out_planes[1] = {
      reinterpret_cast<uint8_t*>(out.data() + old_size)};
  const uint8_t** in_planes =
      frame ? const_cast<const uint8_t**>(frame->extended_data) : nullptr;
  const int got = swr_convert(st.swr, out_planes, max_out, in_planes,
                              static_cast<int>(in_samples));
  if (got < 0) {
    out.resize(old_size);
    return got;
  }
  out.resize(old_size + static_cast<size_t>(got));
  return 0;
}

int open_input(DecoderState& st, const char* path, int out_rate,
               char* errbuf, int errlen) {
  int err = avformat_open_input(&st.fmt, path, nullptr, nullptr);
  if (err < 0) {
    set_error(errbuf, errlen, "open failed: " + av_err_str(err));
    return -1;
  }
  err = avformat_find_stream_info(st.fmt, nullptr);
  if (err < 0) {
    set_error(errbuf, errlen, "stream info failed: " + av_err_str(err));
    return -1;
  }
  const AVCodec* decoder = nullptr;
  const int stream_idx = av_find_best_stream(
      st.fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &decoder, 0);
  if (stream_idx < 0 || !decoder) {
    set_error(errbuf, errlen, "no audio stream found");
    return -1;
  }
  AVStream* stream = st.fmt->streams[stream_idx];

  st.codec = avcodec_alloc_context3(decoder);
  if (!st.codec ||
      avcodec_parameters_to_context(st.codec, stream->codecpar) < 0) {
    set_error(errbuf, errlen, "codec context setup failed");
    return -1;
  }
  err = avcodec_open2(st.codec, decoder, nullptr);
  if (err < 0) {
    set_error(errbuf, errlen, "codec open failed: " + av_err_str(err));
    return -1;
  }

  AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
  AVChannelLayout in_layout;
  if (st.codec->ch_layout.nb_channels > 0) {
    av_channel_layout_copy(&in_layout, &st.codec->ch_layout);
  } else {
    av_channel_layout_default(&in_layout, 1);
  }
  err = swr_alloc_set_opts2(&st.swr, &mono, AV_SAMPLE_FMT_FLT, out_rate,
                            &in_layout, st.codec->sample_fmt,
                            st.codec->sample_rate, 0, nullptr);
  av_channel_layout_uninit(&in_layout);
  if (err < 0 || !st.swr || swr_init(st.swr) < 0) {
    set_error(errbuf, errlen, "resampler init failed");
    return -1;
  }

  st.packet = av_packet_alloc();
  st.frame = av_frame_alloc();
  if (!st.packet || !st.frame) {
    set_error(errbuf, errlen, "allocation failed");
    return -1;
  }
  return stream_idx;
}

}  // namespace

extern "C" {

// Decode `path` to mono float32 at `sample_rate`. On success returns 0 and
// hands ownership of *out_samples (malloc'd) to the caller. On failure
// returns <0 and fills errbuf.
int wnt_decode_audio(const char* path, int sample_rate,
                     float** out_samples, int64_t* out_n_samples,
                     char* errbuf, int errlen) {
  if (!path || !out_samples || !out_n_samples || sample_rate <= 0) {
    set_error(errbuf, errlen, "invalid arguments");
    return -1;
  }
  *out_samples = nullptr;
  *out_n_samples = 0;

  DecoderState st;
  const int stream_idx = open_input(st, path, sample_rate, errbuf, errlen);
  if (stream_idx < 0) return -2;

  std::vector<float> samples;
  if (st.fmt->duration > 0) {
    samples.reserve(static_cast<size_t>(
        (st.fmt->duration * static_cast<int64_t>(sample_rate)) /
            AV_TIME_BASE +
        sample_rate));
  }

  int err;
  bool draining = false;
  while (true) {
    if (!draining) {
      err = av_read_frame(st.fmt, st.packet);
      if (err == AVERROR_EOF) {
        draining = true;
        avcodec_send_packet(st.codec, nullptr);  // flush decoder
      } else if (err < 0) {
        set_error(errbuf, errlen, "read failed: " + av_err_str(err));
        return -3;
      } else {
        if (st.packet->stream_index != stream_idx) {
          av_packet_unref(st.packet);
          continue;
        }
        err = avcodec_send_packet(st.codec, st.packet);
        av_packet_unref(st.packet);
        if (err < 0 && err != AVERROR(EAGAIN)) {
          set_error(errbuf, errlen, "decode failed: " + av_err_str(err));
          return -4;
        }
      }
    }
    while (true) {
      err = avcodec_receive_frame(st.codec, st.frame);
      if (err == AVERROR(EAGAIN)) break;
      if (err == AVERROR_EOF) goto flush_resampler;
      if (err < 0) {
        set_error(errbuf, errlen, "receive failed: " + av_err_str(err));
        return -5;
      }
      err = resample_frame(st, st.frame, sample_rate, samples);
      av_frame_unref(st.frame);
      if (err < 0) {
        set_error(errbuf, errlen, "resample failed: " + av_err_str(err));
        return -6;
      }
    }
  }

flush_resampler:
  err = resample_frame(st, nullptr, sample_rate, samples);
  if (err < 0) {
    set_error(errbuf, errlen, "resampler flush failed: " + av_err_str(err));
    return -7;
  }

  float* buf = static_cast<float*>(
      std::malloc(samples.size() * sizeof(float)));
  if (!buf) {
    set_error(errbuf, errlen, "out of memory");
    return -8;
  }
  std::memcpy(buf, samples.data(), samples.size() * sizeof(float));
  *out_samples = buf;
  *out_n_samples = static_cast<int64_t>(samples.size());
  return 0;
}

void wnt_free(float* p) { std::free(p); }

// Container-reported duration in seconds (for scheduling before decode),
// or <0 on error.
double wnt_probe_duration(const char* path, char* errbuf, int errlen) {
  AVFormatContext* fmt = nullptr;
  int err = avformat_open_input(&fmt, path, nullptr, nullptr);
  if (err < 0) {
    set_error(errbuf, errlen, "open failed: " + av_err_str(err));
    return -1.0;
  }
  err = avformat_find_stream_info(fmt, nullptr);
  double duration = -1.0;
  if (err >= 0 && fmt->duration > 0) {
    duration = static_cast<double>(fmt->duration) / AV_TIME_BASE;
  }
  avformat_close_input(&fmt);
  return duration;
}

}  // extern "C"
