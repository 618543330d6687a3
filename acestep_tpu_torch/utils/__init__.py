"""Utilities of the port that need neither the card nor JAX: safetensors
files, WAV (audio), FLAC (flac) and MP3 (mp3) IO."""
