"""Inference interfaces of the port: the TTS and vocoder eval interfaces."""
