"""Ogg/Vorbis and Ogg/Opus audio IO over the system's codec libraries, through
ctypes (counterpart of ``speechflow_tpu/io/codecs.py``):

* read ``.ogg``: libvorbisfile (``ov_fopen`` / ``ov_read``), 16-bit PCM;
* write ``.ogg``: libvorbisenc and libvorbis, pages by libogg;
* read and write ``.opus``: libopus's raw codec inside a pure-Python Ogg
  container (RFC 7845 OpusHead / OpusTags, RFC 3533 pages with the Ogg CRC-32).

Where a library is absent, the entry point that needs it raises
``RuntimeError`` naming it; nothing falls back to another reader.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
import typing as tp
from pathlib import Path

import numpy as np

__all__ = ["read_ogg_vorbis", "write_ogg_vorbis", "read_ogg_opus", "write_ogg_opus",
           "ogg_codec_of", "available", "OGG_AVAILABLE", "OPUS_AVAILABLE"]


def _load(name: str):
    path = ctypes.util.find_library(name)
    if path is None:
        return None
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


#: each codec library by its short name (None where ctypes finds none)
LIBS = {name: _load(name) for name in ("ogg", "vorbis", "vorbisfile", "vorbisenc", "opus")}
#: whether this machine reads and writes Ogg/Vorbis (all four libraries found)
OGG_AVAILABLE = all(LIBS[name] is not None for name in ("ogg", "vorbis", "vorbisfile", "vorbisenc"))
#: whether this machine has libopus
OPUS_AVAILABLE = LIBS["opus"] is not None


def available() -> tp.Dict[str, bool]:
    """Which of the codec libraries ctypes found, by library file name."""
    return {f"lib{name}": lib is not None for name, lib in LIBS.items()}


def _require(what: str, *names: str) -> tp.List[tp.Any]:
    """The libraries ``names``; a ``RuntimeError`` naming the first absent one."""
    for name in names:
        if LIBS[name] is None:
            raise RuntimeError(f"{what} needs lib{name}, which ctypes.util.find_library "
                               "did not find on this machine")
    return [LIBS[name] for name in names]


# --------------------------------------------------------------------------- #
#  stable C struct mirrors (layouts fixed by the libogg/libvorbis ABI)        #
# --------------------------------------------------------------------------- #


class _OggPacket(ctypes.Structure):
    _fields_ = [("packet", ctypes.POINTER(ctypes.c_ubyte)),
                ("bytes", ctypes.c_long),
                ("b_o_s", ctypes.c_long),
                ("e_o_s", ctypes.c_long),
                ("granulepos", ctypes.c_int64),
                ("packetno", ctypes.c_int64)]


class _OggPage(ctypes.Structure):
    _fields_ = [("header", ctypes.POINTER(ctypes.c_ubyte)),
                ("header_len", ctypes.c_long),
                ("body", ctypes.POINTER(ctypes.c_ubyte)),
                ("body_len", ctypes.c_long)]


class _VorbisInfo(ctypes.Structure):
    _fields_ = [("version", ctypes.c_int),
                ("channels", ctypes.c_int),
                ("rate", ctypes.c_long),
                ("bitrate_upper", ctypes.c_long),
                ("bitrate_nominal", ctypes.c_long),
                ("bitrate_lower", ctypes.c_long),
                ("bitrate_window", ctypes.c_long),
                ("codec_setup", ctypes.c_void_p)]


def _opaque(size: int = 4096):
    """Generously sized zeroed buffer for structs we never read fields of."""
    return ctypes.create_string_buffer(size)


# --------------------------------------------------------------------------- #
#  Ogg/Vorbis read (libvorbisfile)                                            #
# --------------------------------------------------------------------------- #


def read_ogg_vorbis(path: tp.Union[str, Path]) -> tp.Tuple[np.ndarray, int]:
    """Decode an Ogg/Vorbis file -> (float32 waveform (T,) or (T, C), rate)."""
    _vorbisfile, = _require("ogg/vorbis read", "vorbisfile")
    vf = _opaque(2048)  # OggVorbis_File is ~944 bytes; opaque is fine
    rc = _vorbisfile.ov_fopen(str(path).encode(), vf)
    if rc != 0:
        raise ValueError(f"not a decodable Ogg/Vorbis file: {path} (rc={rc})")
    try:
        _vorbisfile.ov_info.restype = ctypes.POINTER(_VorbisInfo)
        info = _vorbisfile.ov_info(vf, -1).contents
        channels, rate = info.channels, int(info.rate)
        chunks = []
        buf = ctypes.create_string_buffer(65536)
        bitstream = ctypes.c_int(0)
        while True:
            n = _vorbisfile.ov_read(vf, buf, len(buf), 0, 2, 1,
                                    ctypes.byref(bitstream))
            if n <= 0:
                break
            chunks.append(np.frombuffer(buf.raw[:n], np.int16).copy())
    finally:
        _vorbisfile.ov_clear(vf)
    pcm = (np.concatenate(chunks) if chunks else np.zeros(0, np.int16))
    wav = pcm.astype(np.float32) / 32768.0
    if channels > 1:
        wav = wav.reshape(-1, channels)
    return wav, rate


# --------------------------------------------------------------------------- #
#  Ogg/Vorbis write (libvorbisenc + libogg)                                   #
# --------------------------------------------------------------------------- #


def write_ogg_vorbis(path: tp.Union[str, Path], wav: np.ndarray, sr: int,
                     quality: float = 0.4) -> Path:
    """Encode float32 mono/stereo PCM to Ogg/Vorbis (VBR ``quality`` -0.1..1)."""
    _ogg, _vorbis, _vorbisenc = _require("ogg/vorbis write", "ogg", "vorbis", "vorbisenc")
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 1:
        wav = wav[:, None]
    channels = wav.shape[1]

    vi = _opaque(256)          # vorbis_info
    _vorbis.vorbis_info_init(vi)
    rc = _vorbisenc.vorbis_encode_init_vbr(
        vi, ctypes.c_long(channels), ctypes.c_long(sr), ctypes.c_float(quality))
    if rc != 0:
        _vorbis.vorbis_info_clear(vi)
        raise ValueError(f"vorbis_encode_init_vbr failed (rc={rc}, sr={sr})")

    vc = _opaque(64)           # vorbis_comment
    vd = _opaque(4096)         # vorbis_dsp_state
    vb = _opaque(1024)         # vorbis_block
    os_ = _opaque(1024)        # ogg_stream_state
    _vorbis.vorbis_comment_init(vc)
    _vorbis.vorbis_analysis_init(vd, vi)
    _vorbis.vorbis_block_init(vd, vb)
    _ogg.ogg_stream_init(os_, 0xF10C5)

    header, header_comm, header_code = _OggPacket(), _OggPacket(), _OggPacket()
    _vorbis.vorbis_analysis_headerout(vd, vc, ctypes.byref(header),
                                      ctypes.byref(header_comm),
                                      ctypes.byref(header_code))
    for pkt in (header, header_comm, header_code):
        _ogg.ogg_stream_packetin(os_, ctypes.byref(pkt))

    page = _OggPage()
    out = bytearray()

    def flush_pages(force: bool) -> None:
        fn = _ogg.ogg_stream_flush if force else _ogg.ogg_stream_pageout
        while fn(os_, ctypes.byref(page)) != 0:
            out.extend(ctypes.string_at(page.header, page.header_len))
            out.extend(ctypes.string_at(page.body, page.body_len))

    flush_pages(True)  # headers must end their own page before audio

    _vorbis.vorbis_analysis_buffer.restype = ctypes.POINTER(
        ctypes.POINTER(ctypes.c_float))
    pkt = _OggPacket()

    def drain() -> None:
        while _vorbis.vorbis_analysis_blockout(vd, vb) == 1:
            _vorbis.vorbis_analysis(vb, None)
            _vorbis.vorbis_bitrate_addblock(vb)
            while _vorbis.vorbis_bitrate_flushpacket(vd, ctypes.byref(pkt)) == 1:
                _ogg.ogg_stream_packetin(os_, ctypes.byref(pkt))
                flush_pages(False)

    CHUNK = 4096
    for ofs in range(0, len(wav), CHUNK):
        block = wav[ofs: ofs + CHUNK]
        buf = _vorbis.vorbis_analysis_buffer(vd, len(block))
        for c in range(channels):
            ctypes.memmove(buf[c],
                           np.ascontiguousarray(block[:, c]).ctypes.data,
                           len(block) * 4)
        _vorbis.vorbis_analysis_wrote(vd, len(block))
        drain()
    _vorbis.vorbis_analysis_wrote(vd, 0)  # EOS
    drain()
    flush_pages(True)

    for obj, fn in ((os_, _ogg.ogg_stream_clear), (vb, _vorbis.vorbis_block_clear),
                    (vd, _vorbis.vorbis_dsp_clear), (vc, _vorbis.vorbis_comment_clear),
                    (vi, _vorbis.vorbis_info_clear)):
        fn(obj)

    path = Path(path)
    path.write_bytes(bytes(out))
    return path


# --------------------------------------------------------------------------- #
#  pure-python Ogg container (for Opus, which has no file lib on the image)   #
# --------------------------------------------------------------------------- #

_CRC_TABLE = []


def _ogg_crc(data: bytes) -> int:
    """Ogg CRC-32: poly 0x04c11db7, init 0, no reflection, no final xor."""
    if not _CRC_TABLE:
        for i in range(256):
            r = i << 24
            for _ in range(8):
                r = ((r << 1) ^ 0x04C11DB7 if r & 0x80000000 else r << 1) & 0xFFFFFFFF
            _CRC_TABLE.append(r)
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _CRC_TABLE[((crc >> 24) & 0xFF) ^ b]
    return crc


def _ogg_pages(blob: bytes):
    """Yield (granulepos, serial, page_seq, flags, [segments bytes]) per page."""
    pos = 0
    while True:
        pos = blob.find(b"OggS", pos)
        if pos < 0:
            return
        if pos + 27 > len(blob):
            return
        (_, flags, granule, serial, seq, _crc, n_segs) = struct.unpack_from(
            "<BBqIIIB", blob, pos + 4)
        lacing = blob[pos + 27: pos + 27 + n_segs]
        body_start = pos + 27 + n_segs
        body_len = sum(lacing)
        body = blob[body_start: body_start + body_len]
        yield granule, serial, seq, flags, lacing, body
        pos = body_start + body_len


def _ogg_packets(blob: bytes):
    """Reassemble packets across pages (single logical stream assumed)."""
    pending = b""
    for _gran, _ser, _seq, _flags, lacing, body in _ogg_pages(blob):
        ofs = 0
        for lace in lacing:
            pending += body[ofs: ofs + lace]
            ofs += lace
            if lace < 255:
                yield pending
                pending = b""
    if pending:
        yield pending


def _ogg_page_bytes(segments: tp.List[bytes], serial: int, seq: int,
                    granule: int, flags: int) -> bytes:
    lacing = bytearray()
    body = bytearray()
    for seg in segments:
        n = len(seg)
        while n >= 255:
            lacing.append(255)
            n -= 255
        lacing.append(n)
        body.extend(seg)
    header = bytearray(b"OggS")
    header += struct.pack("<BBqIIIB", 0, flags, granule, serial, seq, 0,
                          len(lacing))
    header += lacing
    page = bytes(header) + bytes(body)
    crc = _ogg_crc(page)
    return page[:22] + struct.pack("<I", crc) + page[26:]


def ogg_codec_of(path: tp.Union[str, Path]) -> str:
    """'vorbis' | 'opus' | 'unknown' from the first Ogg packet magic."""
    with open(path, "rb") as f:
        head = f.read(512)
    if not head.startswith(b"OggS"):
        return "unknown"
    if b"OpusHead" in head:
        return "opus"
    if b"\x01vorbis" in head:
        return "vorbis"
    return "unknown"


# --------------------------------------------------------------------------- #
#  Ogg/Opus (libopus codec + the container above, RFC 7845)                   #
# --------------------------------------------------------------------------- #

_OPUS_SR = 48000            # opus codec always runs at 48 kHz
_OPUS_FRAME = 960           # 20 ms @ 48 kHz
_OPUS_APPLICATION_AUDIO = 2049


def read_ogg_opus(path: tp.Union[str, Path]) -> tp.Tuple[np.ndarray, int]:
    """Decode an Ogg/Opus file -> (float32 waveform, 48000).

    The OpusHead pre-skip is honoured; output is mono/stereo float32 at the
    codec rate (callers resample via AudioChunk as needed)."""
    _opus, = _require("opus read", "opus")
    blob = Path(path).read_bytes()
    packets = list(_ogg_packets(blob))
    if not packets or not packets[0].startswith(b"OpusHead"):
        raise ValueError(f"not an Ogg/Opus file: {path}")
    version, channels, pre_skip = struct.unpack_from("<BBH", packets[0], 8)
    err = ctypes.c_int(0)
    _opus.opus_decoder_create.restype = ctypes.c_void_p
    dec = _opus.opus_decoder_create(_OPUS_SR, channels, ctypes.byref(err))
    if err.value != 0:
        raise RuntimeError(f"opus_decoder_create failed ({err.value})")
    try:
        max_frame = 5760  # 120 ms
        pcm = (ctypes.c_float * (max_frame * channels))()
        chunks = []
        for pkt in packets[1:]:
            if pkt.startswith(b"OpusTags"):
                continue
            n = _opus.opus_decode_float(ctypes.c_void_p(dec), pkt, len(pkt),
                                        pcm, max_frame, 0)
            if n > 0:
                chunks.append(np.frombuffer(pcm, np.float32,
                                            n * channels).copy())
    finally:
        _opus.opus_decoder_destroy(ctypes.c_void_p(dec))
    wav = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    if channels > 1:
        wav = wav.reshape(-1, channels)
    return wav[pre_skip:], _OPUS_SR


def write_ogg_opus(path: tp.Union[str, Path], wav: np.ndarray, sr: int,
                   bitrate: int = 64000) -> Path:
    """Encode float32 PCM to Ogg/Opus.  Input of any rate is resampled to
    48 kHz host-side first (the opus codec is 48 kHz-only)."""
    _opus, = _require("opus write", "opus")
    from scipy.signal import resample_poly

    wav = np.asarray(wav, np.float32)
    if wav.ndim == 1:
        wav = wav[:, None]
    channels = wav.shape[1]
    if sr != _OPUS_SR:
        g = np.gcd(int(sr), _OPUS_SR)
        wav = resample_poly(wav, _OPUS_SR // g, sr // g, axis=0).astype(np.float32)

    err = ctypes.c_int(0)
    _opus.opus_encoder_create.restype = ctypes.c_void_p
    enc = _opus.opus_encoder_create(_OPUS_SR, channels,
                                    _OPUS_APPLICATION_AUDIO, ctypes.byref(err))
    if err.value != 0:
        raise RuntimeError(f"opus_encoder_create failed ({err.value})")
    OPUS_SET_BITRATE_REQUEST = 4002
    _opus.opus_encoder_ctl(ctypes.c_void_p(enc), OPUS_SET_BITRATE_REQUEST,
                           ctypes.c_int(bitrate))

    serial = 0x5F10C5
    pages = []
    # RFC 7845 headers: OpusHead (pre-skip 0: we feed aligned audio) + OpusTags
    head = b"OpusHead" + struct.pack("<BBHIhB", 1, channels, 0, _OPUS_SR, 0, 0)
    vendor = b"speechflow_torch"
    tags = b"OpusTags" + struct.pack("<I", len(vendor)) + vendor + struct.pack("<I", 0)
    pages.append(_ogg_page_bytes([head], serial, 0, 0, 0x02))   # BOS
    pages.append(_ogg_page_bytes([tags], serial, 1, 0, 0))

    n = len(wav)
    pad = (-n) % _OPUS_FRAME
    wav = np.pad(wav, ((0, pad), (0, 0)))
    out = ctypes.create_string_buffer(4000)
    segments: tp.List[bytes] = []
    seq = 2
    granule = 0
    try:
        for ofs in range(0, len(wav), _OPUS_FRAME):
            frame = np.ascontiguousarray(wav[ofs: ofs + _OPUS_FRAME])
            nb = _opus.opus_encode_float(
                ctypes.c_void_p(enc),
                frame.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                _OPUS_FRAME, out, len(out))
            if nb < 0:
                raise RuntimeError(f"opus_encode_float failed ({nb})")
            segments.append(out.raw[:nb])
            granule += _OPUS_FRAME
            last = ofs + _OPUS_FRAME >= len(wav)
            if len(segments) >= 50 or last:
                pages.append(_ogg_page_bytes(segments, serial, seq, granule,
                                             0x04 if last else 0))
                segments, seq = [], seq + 1
    finally:
        _opus.opus_encoder_destroy(ctypes.c_void_p(enc))

    path = Path(path)
    path.write_bytes(b"".join(pages))
    return path
