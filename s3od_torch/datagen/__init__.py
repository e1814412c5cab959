"""The synthetic-data factory's generation path on the card (counterpart
of `s3od_tpu/datagen/`): text encoders -> MMDiT with concept attention ->
VAE -> FluxDPT teacher mask."""
