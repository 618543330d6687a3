"""Constants the port's text2music path needs (own copy; same values as the
JAX package's constants module)."""

SAMPLE_RATE = 48000
LATENT_HOP = 1920                 # samples per latent frame -> 25 Hz
LATENT_RATE = SAMPLE_RATE / LATENT_HOP

MIN_DURATION_S = 10.0
MAX_DURATION_S = 600.0

FRAME_BUCKET = 256                # latent frames per sequence bucket (~10.24 s)
TOKEN_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)
