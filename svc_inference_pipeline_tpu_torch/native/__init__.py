"""Native host codecs (C++), through ctypes: WAV and FLAC decoding, the
16-bit WAV encoder and the polyphase resampler of the repo's
``native/*.cc``. The library is built at first use
(:mod:`svc_inference_pipeline_tpu_torch.native.wav_codec`); callers in
``utils/audio_io.py`` and ``ops/resample.py`` fall back to numpy for WAV and
resampling where it cannot be built."""
