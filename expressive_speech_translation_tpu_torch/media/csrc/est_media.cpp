// est_media — C++ libav media shim.
//
// Replaces the reference's ffmpeg subprocess contract (Backend/app.py:36-57
// audio extraction, services/video_routes.py:41-59 transcode / :79-100
// extract / :163-190 mux, Docker/api_inference_logic.py:83/:176-180 frame
// extract & stitch) with an in-process library: decode any container/codec to
// float32 PCM, extract/resample audio, decode video frames to RGB24, mux a
// new audio track into a video (stream-copying the video), and encode frames
// + audio back into a container.
//
// C ABI for ctypes (media/native.py). All buffers returned via est_* are
// malloc'd and must be released with est_free. Errors: negative return codes;
// est_last_error() gives a message (thread-local).
//
// Build: media/native.py build() (g++ and libav's headers) →
// _build/libest_media-<hash of this file>.so

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/avutil.h>
#include <libavutil/opt.h>
#include <libavutil/imgutils.h>
#include <libavutil/channel_layout.h>
#include <libswresample/swresample.h>
#include <libswscale/swscale.h>
}

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

static thread_local std::string g_error;

static int fail(const std::string& msg, int code = -1) {
    g_error = msg;
    return code;
}

extern "C" {

const char* est_last_error() { return g_error.c_str(); }

void est_free(void* p) { free(p); }

// ---------------------------------------------------------------- audio decode

// Decode the best audio stream of `path` to interleaved float32.
// target_rate = 0 keeps the native rate; channels are downmixed to `target_channels`
// (0 = keep native).
int est_decode_audio(const char* path, int target_rate, int target_channels,
                     float** out, long* out_samples, int* out_channels, int* out_rate) {
    AVFormatContext* fmt = nullptr;
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0)
        return fail(std::string("cannot open ") + path);
    if (avformat_find_stream_info(fmt, nullptr) < 0) {
        avformat_close_input(&fmt);
        return fail("no stream info");
    }
    const AVCodec* codec = nullptr;
    int stream_idx = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
    if (stream_idx < 0 || !codec) {
        avformat_close_input(&fmt);
        return fail("no audio stream");
    }
    AVStream* stream = fmt->streams[stream_idx];
    AVCodecContext* ctx = avcodec_alloc_context3(codec);
    avcodec_parameters_to_context(ctx, stream->codecpar);
    if (avcodec_open2(ctx, codec, nullptr) < 0) {
        avcodec_free_context(&ctx);
        avformat_close_input(&fmt);
        return fail("cannot open decoder");
    }

    int in_rate = ctx->sample_rate;
    int rate = target_rate > 0 ? target_rate : in_rate;
    int in_ch = ctx->ch_layout.nb_channels;
    int ch = target_channels > 0 ? target_channels : in_ch;

    SwrContext* swr = nullptr;
    AVChannelLayout out_layout;
    av_channel_layout_default(&out_layout, ch);
    if (swr_alloc_set_opts2(&swr, &out_layout, AV_SAMPLE_FMT_FLT, rate,
                            &ctx->ch_layout, ctx->sample_fmt, in_rate, 0, nullptr) < 0 ||
        swr_init(swr) < 0) {
        avcodec_free_context(&ctx);
        avformat_close_input(&fmt);
        return fail("cannot init resampler");
    }

    std::vector<float> pcm;
    AVPacket* pkt = av_packet_alloc();
    AVFrame* frame = av_frame_alloc();
    std::vector<float> tmp;

    auto drain = [&](AVFrame* f) {
        int max_out = swr_get_out_samples(swr, f ? f->nb_samples : 0);
        if (max_out <= 0) return;
        tmp.resize((size_t)max_out * ch);
        uint8_t* outp = (uint8_t*)tmp.data();
        int got = swr_convert(swr, &outp, max_out,
                              f ? (const uint8_t**)f->extended_data : nullptr,
                              f ? f->nb_samples : 0);
        if (got > 0) pcm.insert(pcm.end(), tmp.begin(), tmp.begin() + (size_t)got * ch);
    };

    while (av_read_frame(fmt, pkt) >= 0) {
        if (pkt->stream_index == stream_idx) {
            if (avcodec_send_packet(ctx, pkt) >= 0) {
                while (avcodec_receive_frame(ctx, frame) >= 0) drain(frame);
            }
        }
        av_packet_unref(pkt);
    }
    avcodec_send_packet(ctx, nullptr);                      // flush decoder
    while (avcodec_receive_frame(ctx, frame) >= 0) drain(frame);
    drain(nullptr);                                         // flush resampler

    av_frame_free(&frame);
    av_packet_free(&pkt);
    swr_free(&swr);
    avcodec_free_context(&ctx);
    avformat_close_input(&fmt);

    if (pcm.empty()) return fail("decoded zero samples");
    float* buf = (float*)malloc(pcm.size() * sizeof(float));
    memcpy(buf, pcm.data(), pcm.size() * sizeof(float));
    *out = buf;
    *out_samples = (long)(pcm.size() / ch);
    *out_channels = ch;
    *out_rate = rate;
    return 0;
}

// ---------------------------------------------------------------- video decode

// Decode video frames to packed RGB24 at native resolution.
// max_frames = 0 → all frames; frame_step N keeps every Nth frame.
int est_decode_video(const char* path, long max_frames, int frame_step,
                     uint8_t** out, long* out_frames, int* out_w, int* out_h,
                     double* out_fps) {
    AVFormatContext* fmt = nullptr;
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0)
        return fail(std::string("cannot open ") + path);
    if (avformat_find_stream_info(fmt, nullptr) < 0) {
        avformat_close_input(&fmt);
        return fail("no stream info");
    }
    const AVCodec* codec = nullptr;
    int vidx = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
    if (vidx < 0 || !codec) {
        avformat_close_input(&fmt);
        return fail("no video stream");
    }
    AVStream* stream = fmt->streams[vidx];
    AVCodecContext* ctx = avcodec_alloc_context3(codec);
    avcodec_parameters_to_context(ctx, stream->codecpar);
    if (avcodec_open2(ctx, codec, nullptr) < 0) {
        avcodec_free_context(&ctx);
        avformat_close_input(&fmt);
        return fail("cannot open video decoder");
    }
    AVRational fr = av_guess_frame_rate(fmt, stream, nullptr);
    *out_fps = fr.den ? (double)fr.num / fr.den : 25.0;

    int w = ctx->width, h = ctx->height;
    SwsContext* sws = sws_getContext(w, h, ctx->pix_fmt, w, h, AV_PIX_FMT_RGB24,
                                     SWS_BILINEAR, nullptr, nullptr, nullptr);
    if (!sws) {
        avcodec_free_context(&ctx);
        avformat_close_input(&fmt);
        return fail("cannot init scaler");
    }
    if (frame_step < 1) frame_step = 1;

    std::vector<uint8_t> frames;
    const size_t frame_bytes = (size_t)w * h * 3;
    long count = 0, seen = 0;
    AVPacket* pkt = av_packet_alloc();
    AVFrame* frame = av_frame_alloc();
    std::vector<uint8_t> rgb(frame_bytes);
    uint8_t* dst[1] = {rgb.data()};
    int dst_stride[1] = {w * 3};

    auto take = [&](AVFrame* f) {
        if (seen++ % frame_step != 0) return;
        if (max_frames > 0 && count >= max_frames) return;
        sws_scale(sws, f->data, f->linesize, 0, h, dst, dst_stride);
        frames.insert(frames.end(), rgb.begin(), rgb.end());
        count++;
    };

    while (av_read_frame(fmt, pkt) >= 0 && (max_frames <= 0 || count < max_frames)) {
        if (pkt->stream_index == vidx && avcodec_send_packet(ctx, pkt) >= 0) {
            while (avcodec_receive_frame(ctx, frame) >= 0) take(frame);
        }
        av_packet_unref(pkt);
    }
    avcodec_send_packet(ctx, nullptr);
    while (avcodec_receive_frame(ctx, frame) >= 0) take(frame);

    av_frame_free(&frame);
    av_packet_free(&pkt);
    sws_freeContext(sws);
    avcodec_free_context(&ctx);
    avformat_close_input(&fmt);

    if (count == 0) return fail("decoded zero frames");
    uint8_t* buf = (uint8_t*)malloc(frames.size());
    memcpy(buf, frames.data(), frames.size());
    *out = buf;
    *out_frames = count;
    *out_w = w;
    *out_h = h;
    return 0;
}

// ----------------------------------------------------------------- audio encode

static int encode_audio_stream(AVFormatContext* ofmt, AVStream* ast, AVCodecContext* actx,
                               const float* audio, long n_samples, int rate) {
    AVFrame* af = av_frame_alloc();
    AVPacket* pkt = av_packet_alloc();
    int frame_size = actx->frame_size > 0 ? actx->frame_size : 1024;
    long pos = 0;
    int64_t pts = 0;
    int err = 0;

    auto send_frame = [&](AVFrame* f) -> int {
        if (avcodec_send_frame(actx, f) < 0) return -1;
        while (true) {
            int r = avcodec_receive_packet(actx, pkt);
            if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
            if (r < 0) return -1;
            av_packet_rescale_ts(pkt, actx->time_base, ast->time_base);
            pkt->stream_index = ast->index;
            if (av_interleaved_write_frame(ofmt, pkt) < 0) return -1;
        }
        return 0;
    };

    while (pos < n_samples && !err) {
        int chunk = (int)((n_samples - pos) < frame_size ? (n_samples - pos) : frame_size);
        af->nb_samples = chunk;
        af->format = actx->sample_fmt;
        av_channel_layout_copy(&af->ch_layout, &actx->ch_layout);
        af->sample_rate = rate;
        if (av_frame_get_buffer(af, 0) < 0) { err = 1; break; }
        if (actx->sample_fmt == AV_SAMPLE_FMT_FLTP) {
            memcpy(af->data[0], audio + pos, chunk * sizeof(float));
        } else {  // AV_SAMPLE_FMT_FLT / S16 conversions
            if (actx->sample_fmt == AV_SAMPLE_FMT_FLT) {
                memcpy(af->data[0], audio + pos, chunk * sizeof(float));
            } else if (actx->sample_fmt == AV_SAMPLE_FMT_S16) {
                int16_t* d = (int16_t*)af->data[0];
                for (int i = 0; i < chunk; i++) {
                    float v = audio[pos + i];
                    v = v > 1.f ? 1.f : (v < -1.f ? -1.f : v);
                    d[i] = (int16_t)(v * 32767.f);
                }
            } else { err = 1; break; }
        }
        af->pts = pts;
        pts += chunk;
        if (send_frame(af)) { err = 1; }
        av_frame_unref(af);
        pos += chunk;
    }
    if (!err && send_frame(nullptr)) err = 1;
    av_frame_free(&af);
    av_packet_free(&pkt);
    return err ? -1 : 0;
}

// Encode the PCM into a packet list (rescaled to ast->time_base,
// stream_index set) WITHOUT writing: callers interleave these against video
// packets by dts. Writing all video first and audio after defeats
// av_interleaved_write_frame (it cannot interleave against packets that do
// not exist yet and force-flushes video-only), laying the file out as
// [all video][all audio] — progressive playback then stalls until the tail.
static int collect_audio_packets(AVStream* ast, AVCodecContext* actx,
                                 const float* audio, long n_samples, int rate,
                                 std::vector<AVPacket*>& out_pkts) {
    AVFrame* af = av_frame_alloc();
    int frame_size = actx->frame_size > 0 ? actx->frame_size : 1024;
    long pos = 0;
    int64_t pts = 0;
    int err = 0;

    auto send_frame = [&](AVFrame* f) -> int {
        if (avcodec_send_frame(actx, f) < 0) return -1;
        while (true) {
            AVPacket* pkt = av_packet_alloc();
            int r = avcodec_receive_packet(actx, pkt);
            if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) { av_packet_free(&pkt); break; }
            if (r < 0) { av_packet_free(&pkt); return -1; }
            av_packet_rescale_ts(pkt, actx->time_base, ast->time_base);
            pkt->stream_index = ast->index;
            out_pkts.push_back(pkt);
        }
        return 0;
    };

    while (pos < n_samples && !err) {
        int chunk = (int)((n_samples - pos) < frame_size ? (n_samples - pos) : frame_size);
        af->nb_samples = chunk;
        af->format = actx->sample_fmt;
        av_channel_layout_copy(&af->ch_layout, &actx->ch_layout);
        af->sample_rate = rate;
        if (av_frame_get_buffer(af, 0) < 0) { err = 1; break; }
        if (actx->sample_fmt == AV_SAMPLE_FMT_FLTP ||
            actx->sample_fmt == AV_SAMPLE_FMT_FLT) {
            memcpy(af->data[0], audio + pos, chunk * sizeof(float));
        } else if (actx->sample_fmt == AV_SAMPLE_FMT_S16) {
            int16_t* d = (int16_t*)af->data[0];
            for (int i = 0; i < chunk; i++) {
                float v = audio[pos + i];
                v = v > 1.f ? 1.f : (v < -1.f ? -1.f : v);
                d[i] = (int16_t)(v * 32767.f);
            }
        } else { err = 1; break; }
        af->pts = pts;
        pts += chunk;
        if (send_frame(af)) err = 1;
        av_frame_unref(af);
        pos += chunk;
    }
    if (!err && send_frame(nullptr)) err = 1;
    av_frame_free(&af);
    return err ? -1 : 0;
}

static void free_packet_list(std::vector<AVPacket*>& pkts, size_t from) {
    for (size_t i = from; i < pkts.size(); i++) av_packet_free(&pkts[i]);
    pkts.clear();
}

// Try container default → AAC → PCM, returning the first encoder whose
// context actually OPENS (a found-but-unopenable default — e.g. the
// experimental native vorbis encoder for .ogg — must fall through, which a
// find-only probe cannot detect). Returns a configured+opened context or
// nullptr; the caller creates the AVStream only after success, so no
// half-initialized stream is ever registered with the muxer.
static AVCodecContext* open_audio_encoder(AVFormatContext* ofmt, int rate) {
    const AVCodecID candidates[] = {ofmt->oformat->audio_codec,
                                    AV_CODEC_ID_AAC, AV_CODEC_ID_PCM_S16LE};
    for (AVCodecID id : candidates) {
        if (id == AV_CODEC_ID_NONE) continue;
        const AVCodec* c = avcodec_find_encoder(id);
        if (!c) continue;
        AVCodecContext* actx = avcodec_alloc_context3(c);
        if (!actx) continue;
        actx->sample_rate = rate;
        av_channel_layout_default(&actx->ch_layout, 1);
        actx->sample_fmt = c->sample_fmts ? c->sample_fmts[0] : AV_SAMPLE_FMT_FLTP;
        actx->time_base = {1, rate};
        actx->bit_rate = 128000;
        if (ofmt->oformat->flags & AVFMT_GLOBALHEADER)
            actx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
        if (avcodec_open2(actx, c, nullptr) == 0) return actx;
        avcodec_free_context(&actx);
    }
    return nullptr;
}

// Encode mono float32 PCM to `out_path` (container by extension).
int est_encode_audio(const char* out_path, const float* audio, long n_samples, int rate) {
    AVFormatContext* ofmt = nullptr;
    if (avformat_alloc_output_context2(&ofmt, nullptr, nullptr, out_path) < 0 || !ofmt)
        return fail("cannot create output context");
    AVCodecContext* actx = open_audio_encoder(ofmt, rate);
    if (!actx) { avformat_free_context(ofmt); return fail("no openable audio encoder"); }
    AVStream* ast = avformat_new_stream(ofmt, nullptr);
    avcodec_parameters_from_context(ast->codecpar, actx);
    ast->time_base = actx->time_base;

    if (!(ofmt->oformat->flags & AVFMT_NOFILE) &&
        avio_open(&ofmt->pb, out_path, AVIO_FLAG_WRITE) < 0) {
        avcodec_free_context(&actx); avformat_free_context(ofmt);
        return fail("cannot open output file");
    }
    if (avformat_write_header(ofmt, nullptr) < 0) {
        avcodec_free_context(&actx); avformat_free_context(ofmt);
        return fail("cannot write header");
    }
    int r = encode_audio_stream(ofmt, ast, actx, audio, n_samples, rate);
    av_write_trailer(ofmt);
    if (!(ofmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&ofmt->pb);
    avcodec_free_context(&actx);
    avformat_free_context(ofmt);
    return r < 0 ? fail("audio encode failed") : 0;
}

// ------------------------------------------------------------------------ mux

// Replace the audio track of `video_path` with mono float32 `audio`,
// stream-copying the video (services/video_routes.py:163-190 mux parity).
int est_mux_audio_video(const char* video_path, const float* audio, long n_samples,
                        int rate, const char* out_path) {
    AVFormatContext* in = nullptr;
    if (avformat_open_input(&in, video_path, nullptr, nullptr) < 0)
        return fail(std::string("cannot open ") + video_path);
    if (avformat_find_stream_info(in, nullptr) < 0) {
        avformat_close_input(&in);
        return fail("no stream info");
    }
    int vidx = av_find_best_stream(in, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
    if (vidx < 0) { avformat_close_input(&in); return fail("no video stream"); }

    AVFormatContext* out = nullptr;
    if (avformat_alloc_output_context2(&out, nullptr, nullptr, out_path) < 0 || !out) {
        avformat_close_input(&in);
        return fail("cannot create output");
    }
    // video: stream copy
    AVStream* vin = in->streams[vidx];
    AVStream* vout = avformat_new_stream(out, nullptr);
    avcodec_parameters_copy(vout->codecpar, vin->codecpar);
    vout->codecpar->codec_tag = 0;
    vout->time_base = vin->time_base;

    // audio: encode
    AVCodecContext* actx = open_audio_encoder(out, rate);
    if (!actx) { avformat_close_input(&in); avformat_free_context(out); return fail("no openable audio encoder"); }
    AVStream* aout = avformat_new_stream(out, nullptr);
    avcodec_parameters_from_context(aout->codecpar, actx);
    aout->time_base = actx->time_base;

    if (!(out->oformat->flags & AVFMT_NOFILE) &&
        avio_open(&out->pb, out_path, AVIO_FLAG_WRITE) < 0) {
        avcodec_free_context(&actx); avformat_close_input(&in); avformat_free_context(out);
        return fail("cannot open output file");
    }
    if (avformat_write_header(out, nullptr) < 0) {
        avcodec_free_context(&actx); avformat_close_input(&in); avformat_free_context(out);
        return fail("cannot write header");
    }

    // true interleaving: encode the audio packets first, then emit them
    // dts-merged with the copied video packets — see collect_audio_packets
    std::vector<AVPacket*> apkts;
    int r = collect_audio_packets(aout, actx, audio, n_samples, rate, apkts);
    size_t anext = 0;
    AVPacket* pkt = av_packet_alloc();
    if (r == 0) {
        while (av_read_frame(in, pkt) >= 0) {
            if (pkt->stream_index == vidx) {
                av_packet_rescale_ts(pkt, vin->time_base, vout->time_base);
                pkt->stream_index = vout->index;
                while (anext < apkts.size() &&
                       av_compare_ts(apkts[anext]->dts, aout->time_base,
                                     pkt->dts, vout->time_base) <= 0) {
                    av_interleaved_write_frame(out, apkts[anext]);
                    av_packet_free(&apkts[anext]);
                    anext++;
                }
                av_interleaved_write_frame(out, pkt);
            }
            av_packet_unref(pkt);
        }
        for (; anext < apkts.size(); anext++) {
            av_interleaved_write_frame(out, apkts[anext]);
            av_packet_free(&apkts[anext]);
        }
        apkts.clear();
    } else {
        free_packet_list(apkts, anext);
    }
    av_packet_free(&pkt);

    av_write_trailer(out);
    if (!(out->oformat->flags & AVFMT_NOFILE)) avio_closep(&out->pb);
    avcodec_free_context(&actx);
    avformat_close_input(&in);
    avformat_free_context(out);
    return r < 0 ? fail("mux audio encode failed") : 0;
}

// ---------------------------------------------------------------- video encode

// Encode RGB24 frames (+ optional mono audio) into a container
// (api_inference_logic.py:176-180 stitch+mux parity).
int est_encode_video(const char* out_path, const uint8_t* frames, long n_frames,
                     int w, int h, double fps,
                     const float* audio, long n_samples, int audio_rate) {
    AVFormatContext* out = nullptr;
    if (avformat_alloc_output_context2(&out, nullptr, nullptr, out_path) < 0 || !out)
        return fail("cannot create output");
    const AVCodec* vcodec = avcodec_find_encoder(out->oformat->video_codec);
    if (!vcodec) vcodec = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
    if (!vcodec) { avformat_free_context(out); return fail("no video encoder"); }

    AVStream* vst = avformat_new_stream(out, nullptr);
    AVCodecContext* vctx = avcodec_alloc_context3(vcodec);
    vctx->width = w;
    vctx->height = h;
    vctx->pix_fmt = vcodec->pix_fmts ? vcodec->pix_fmts[0] : AV_PIX_FMT_YUV420P;
    AVRational tb = av_d2q(1.0 / fps, 100000);
    vctx->time_base = tb;
    vctx->framerate = {tb.den, tb.num};
    vctx->bit_rate = 2000000;
    vctx->gop_size = 12;
    if (out->oformat->flags & AVFMT_GLOBALHEADER)
        vctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(vctx, vcodec, nullptr) < 0) {
        avcodec_free_context(&vctx); avformat_free_context(out);
        return fail("cannot open video encoder");
    }
    avcodec_parameters_from_context(vst->codecpar, vctx);
    vst->time_base = vctx->time_base;

    // the stream is created only AFTER the encoder opens — a registered
    // stream whose codec failed to open has codec_id NONE codecpar and makes
    // avformat_write_header reject the whole file instead of the intended
    // graceful no-audio fallback
    AVCodecContext* actx = nullptr;
    AVStream* ast = nullptr;
    if (audio && n_samples > 0) {
        actx = open_audio_encoder(out, audio_rate);
        if (actx) {
            ast = avformat_new_stream(out, nullptr);
            avcodec_parameters_from_context(ast->codecpar, actx);
            ast->time_base = actx->time_base;
        }
    }

    if (!(out->oformat->flags & AVFMT_NOFILE) &&
        avio_open(&out->pb, out_path, AVIO_FLAG_WRITE) < 0) {
        avcodec_free_context(&vctx);
        if (actx) avcodec_free_context(&actx);
        avformat_free_context(out);
        return fail("cannot open output file");
    }
    if (avformat_write_header(out, nullptr) < 0) {
        avcodec_free_context(&vctx);
        if (actx) avcodec_free_context(&actx);
        avformat_free_context(out);
        return fail("cannot write header");
    }

    SwsContext* sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h, vctx->pix_fmt,
                                     SWS_BILINEAR, nullptr, nullptr, nullptr);
    AVFrame* vf = av_frame_alloc();
    vf->format = vctx->pix_fmt;
    vf->width = w;
    vf->height = h;
    av_frame_get_buffer(vf, 0);
    AVPacket* pkt = av_packet_alloc();
    int err = 0;

    // encode the audio up front and dts-merge its packets into the video
    // write loop (see collect_audio_packets — writing it after all video
    // lays the file out [all video][all audio])
    std::vector<AVPacket*> apkts;
    size_t anext = 0;
    if (actx && ast &&
        collect_audio_packets(ast, actx, audio, n_samples, audio_rate, apkts) < 0)
        err = 1;

    auto drain_audio_until = [&](int64_t vdts) {
        while (anext < apkts.size() &&
               av_compare_ts(apkts[anext]->dts, ast->time_base,
                             vdts, vst->time_base) <= 0) {
            av_interleaved_write_frame(out, apkts[anext]);
            av_packet_free(&apkts[anext]);
            anext++;
        }
    };

    auto send_v = [&](AVFrame* f) -> int {
        if (avcodec_send_frame(vctx, f) < 0) return -1;
        while (true) {
            int r = avcodec_receive_packet(vctx, pkt);
            if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
            if (r < 0) return -1;
            av_packet_rescale_ts(pkt, vctx->time_base, vst->time_base);
            pkt->stream_index = vst->index;
            drain_audio_until(pkt->dts);
            if (av_interleaved_write_frame(out, pkt) < 0) return -1;
        }
        return 0;
    };

    const size_t frame_bytes = (size_t)w * h * 3;
    for (long i = 0; i < n_frames && !err; i++) {
        av_frame_make_writable(vf);
        const uint8_t* src[1] = {frames + i * frame_bytes};
        int src_stride[1] = {w * 3};
        sws_scale(sws, src, src_stride, 0, h, vf->data, vf->linesize);
        vf->pts = i;
        if (send_v(vf)) err = 1;
    }
    if (!err && send_v(nullptr)) err = 1;

    for (; anext < apkts.size(); anext++) {
        if (!err) av_interleaved_write_frame(out, apkts[anext]);
        av_packet_free(&apkts[anext]);
    }
    apkts.clear();

    av_write_trailer(out);
    if (!(out->oformat->flags & AVFMT_NOFILE)) avio_closep(&out->pb);
    av_packet_free(&pkt);
    av_frame_free(&vf);
    sws_freeContext(sws);
    avcodec_free_context(&vctx);
    if (actx) avcodec_free_context(&actx);
    avformat_free_context(out);
    return err ? fail("video encode failed") : 0;
}

}  // extern "C"
