"""Host-side IO of the port: the audio container and corpus file lists."""
