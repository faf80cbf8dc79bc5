"""The benchmark of the PyTorch and CUDA port
(``audio_only_speech_separation_tpu_torch``); see README.md."""
