"""Movie and localization-table I/O of the port: the lazy movie readers
(raw, TIFF series, MetaMorph STK, Bitplane IMS, Nikon ND2), raw
conversion, the YAML info chain, the HDF5 ``"locs"`` table and the other
tables, the auxiliary files (picks, drift, identifications, spots,
calibrations, masks, user settings, the camera config), the Imaris
writers and the exporters.

Counterpart of picasso_tpu/io.py (load_info :48, save_info :60,
generated_by :69, save_locs :81, load_locs :102, save/load_identifications
:115/:125, load_clusters :131, save_datasets :140, save/load_spots
:149/:173, load_filter :193, load_picks :209, save_picks :248, save_drift
:282, load_drift :288, load_calibration :303, load_mask :317, the user
settings and config :332-:391, AbstractPicassoMovie :397, load_raw :447,
TiffMap :476, STKMovie :661, STKMultiMovie :689, TiffMultiMap :760,
load_tif :846, IMSMovie :862, load_ims :992, load_ims_all :1007, the
Imaris writers :1028-:1216, the ND2 metadata helpers :1232-:1376,
ND2Movie :1380, load_stk :1460, load_movie :1472, the raw conversion
:1493-:1540, the exporters and import_ts :1547-:1746, save_raw :1696).
The files written are byte-compatible with picasso_tpu.io's (the
exporters' text byte for byte, pandas' number formats without pandas),
and the readers return the same frames and info. ``h5py``, ``yaml``,
``imageio`` and ``nd2`` are imported inside the functions that need
them, so the localize path itself needs only numpy, torch and scipy.
"""

from __future__ import annotations

import glob
import os
import re
import struct

import numpy as np

from picasso_torch import __version__, lib


class NoMetadataFileError(FileNotFoundError):
    pass


def load_info(path: str) -> list[dict]:
    """The YAML info chain next to a data file (picasso/io.py:375)."""
    import yaml

    filename = os.path.splitext(path)[0] + ".yaml"
    try:
        with open(filename, "r") as f:
            return list(yaml.load_all(f, Loader=yaml.UnsafeLoader))
    except FileNotFoundError as e:
        raise NoMetadataFileError(e)


def save_info(path: str, info: list[dict],
              default_flow_style: bool = False) -> None:
    """Write the YAML info chain as a multi-document stream."""
    import yaml

    with open(path, "w") as f:
        yaml.dump_all(info, f, default_flow_style=default_flow_style)


# --- movies -----------------------------------------------------------------


class AbstractPicassoMovie:
    """A lazy, frame-indexable movie (picasso/io.py:632). Subclasses give
    ``__len__``, ``get_frame``, ``dtype``, ``shape``, ``info`` and
    ``close``; indexing by an int, a slice or a list of frames is
    shared."""

    def __len__(self) -> int:
        raise NotImplementedError

    def get_frame(self, index: int) -> np.ndarray:
        raise NotImplementedError

    def _read_into(self, index: int, out: np.ndarray) -> None:
        out[...] = self.get_frame(index)

    def __iter__(self):
        for i in range(len(self)):
            yield self.get_frame(i)

    def __getitem__(self, it):
        if isinstance(it, slice):
            it = range(*it.indices(len(self)))
        if isinstance(it, (range, tuple, list, np.ndarray)):
            out = np.empty((len(it), *self.shape[1:]), self.dtype)
            for k, i in enumerate(it):
                self._read_into(int(i), out[k])
            return out
        it = int(it)
        return self.get_frame(it + len(self) if it < 0 else it)

    def tofile(self, file_handle, byte_order: str = "<"):
        for frame in self:
            frame.astype(np.dtype(self.dtype).newbyteorder(byte_order)).tofile(
                file_handle)


def load_raw(path: str):
    """A raw movie as a read-only memmap plus its info chain
    (picasso/io.py:50)."""
    info = load_info(path)
    dtype = np.dtype(info[0]["Data Type"])
    shape = (info[0]["Frames"], info[0]["Height"], info[0]["Width"])
    movie = np.memmap(path, dtype, "r", shape=shape)
    if info[0]["Byte Order"] != "<":
        movie = movie.byteswap()
        info[0]["Byte Order"] = "<"
    return movie, info


_TIFF_SAMPLE_FORMATS = {1: "u", 2: "i", 3: "f"}
_TIFF_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
                    10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TIFF_TYPE_FMTS = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d",
                   16: "Q", 17: "q"}


class TiffMap(AbstractPicassoMovie):
    """Lazy TIFF reader with ``struct`` only: classic and BigTIFF, either
    byte order, uncompressed grayscale frames in strips. A frame whose
    strips lie back to back is read with one ``readinto`` into its
    output; big-endian frames come back little-endian."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        header = self._file.read(8)
        self._bo = {b"II": "<", b"MM": ">"}.get(header[:2])
        if self._bo is None:
            self._file.close()
            raise ValueError(f"{path} is not a TIFF file")
        magic = struct.unpack(self._bo + "H", header[2:4])[0]
        if magic == 42:
            self._big = False
            first_ifd = struct.unpack(self._bo + "I", header[4:8])[0]
        elif magic == 43:
            self._big = True
            first_ifd = struct.unpack(self._bo + "Q", self._file.read(8))[0]
        else:
            self._file.close()
            raise ValueError(f"{path}: unknown TIFF magic {magic}")
        self._frame_offsets: list[list[tuple[int, int]]] = []
        self._parse_ifds(first_ifd)
        if not self._frame_offsets:
            raise ValueError(f"{path}: no image frames found")
        self.first_ifd_description = self._description

    def _unpack(self, fmt: str, data: bytes):
        return struct.unpack(self._bo + fmt, data)

    def _read_ifd(self, offset: int) -> tuple[dict, dict, int]:
        """(tags, element count per tag, next IFD offset)."""
        f = self._file
        f.seek(offset)
        ofmt = "Q" if self._big else "I"
        osize = 8 if self._big else 4
        (n_entries,) = self._unpack(ofmt if self._big else "H",
                                    f.read(8 if self._big else 2))
        entry_size = 4 + 2 * osize
        raw = f.read(entry_size * n_entries)
        (next_ifd,) = self._unpack(ofmt, f.read(osize))
        tags, counts = {}, {}
        for i in range(n_entries):
            entry = raw[i * entry_size:(i + 1) * entry_size]
            tag, typ, count = self._unpack("HH" + ofmt, entry[:4 + osize])
            counts[tag] = count
            field = entry[4 + osize:]
            size = _TIFF_TYPE_SIZES.get(typ, 1) * count
            if size <= len(field):
                data = field[:size]
            else:
                (at,) = self._unpack(ofmt, field[:osize])
                pos = f.tell()
                f.seek(at)
                data = f.read(size)
                f.seek(pos)
            if typ == 2:
                tags[tag] = data.rstrip(b"\0").decode("latin-1", "replace")
            elif typ in _TIFF_TYPE_FMTS:
                vals = self._unpack(_TIFF_TYPE_FMTS[typ] * count, data)
                tags[tag] = vals if count > 1 else vals[0]
            elif typ == 5:  # rational
                vals = self._unpack("II" * count, data)
                rat = tuple(vals[2 * k] / max(vals[2 * k + 1], 1)
                            for k in range(count))
                tags[tag] = rat if count > 1 else rat[0]
        return tags, counts, next_ifd

    def _parse_ifds(self, offset: int):
        self._description = ""
        shape = None
        while offset:
            tags, counts, offset = self._read_ifd(offset)
            if not self._frame_offsets:
                self._first_tag_counts = counts
            width, height = tags.get(256), tags.get(257)
            bits = tags.get(258, 16)
            bits = bits[0] if isinstance(bits, tuple) else bits
            fmt = tags.get(339, 1)
            fmt = fmt[0] if isinstance(fmt, tuple) else fmt
            dtype = np.dtype(
                f"{self._bo}{_TIFF_SAMPLE_FORMATS.get(fmt, 'u')}{bits // 8}")
            strip_offsets, strip_counts = tags.get(273), tags.get(279)
            if strip_offsets is None:
                continue
            if not isinstance(strip_offsets, tuple):
                strip_offsets = (strip_offsets,)
            if strip_counts is None:
                strip_counts = (width * height * dtype.itemsize,)
            elif not isinstance(strip_counts, tuple):
                strip_counts = (strip_counts,)
            if tags.get(259, 1) != 1:
                raise ValueError(f"{self.path}: compressed TIFF not supported")
            if shape is None:
                shape = (height, width)
                self._dtype = dtype
                self._description = tags.get(270, "")
            self._frame_offsets.append(list(zip(strip_offsets, strip_counts)))
        if shape is None:
            raise ValueError(f"{self.path}: no frames")
        self._frame_shape = shape

    def __len__(self) -> int:
        return len(self._frame_offsets)

    @property
    def dtype(self):
        return np.dtype(self._dtype.str.lstrip("<>=|"))

    @property
    def shape(self):
        return (len(self), *self._frame_shape)

    def _read_into(self, index: int, out: np.ndarray) -> None:
        """Frame ``index`` into ``out`` (C-contiguous, self.dtype)."""
        strips = self._frame_offsets[index]
        raw = out.view(np.uint8).reshape(-1)
        f, pos = self._file, 0
        for k, (offset, count) in enumerate(strips):
            count = min(count, raw.size - pos)
            if k == 0 or offset != strips[k - 1][0] + strips[k - 1][1]:
                f.seek(offset)
            if f.readinto(raw[pos:pos + count]) != count:
                raise ValueError(f"{self.path}: frame {index} is truncated")
            pos += count
        if pos != raw.size:
            raise ValueError(f"{self.path}: frame {index} is truncated")
        if self._bo == ">":
            out.byteswap(inplace=True)

    def get_frame(self, index: int) -> np.ndarray:
        out = np.empty(self._frame_shape, self.dtype)
        self._read_into(index, out)
        return out

    def info(self) -> dict:
        return {
            "Byte Order": "<",
            "Data Type": self.dtype.name,
            "File": self.path,
            "Frames": len(self),
            "Height": self._frame_shape[0],
            "Width": self._frame_shape[1],
        }

    def close(self):
        self._file.close()


_UIC2_TAG = 33629  # MetaMorph STK: its count is the number of planes


class STKMovie(TiffMap):
    """MetaMorph STK (picasso/io.py:1447): a TIFF with one IFD whose
    planes follow the first plane's pixels back to back; the plane count
    is the element count of the UIC2 tag."""

    def __init__(self, path: str):
        super().__init__(path)
        n_planes = int(self._first_tag_counts.get(_UIC2_TAG,
                                                  len(self._frame_offsets)))
        if len(self._frame_offsets) == 1 and n_planes > 1:
            first = self._frame_offsets[0][0][0]
            nbytes = (self._frame_shape[0] * self._frame_shape[1]
                      * self._dtype.itemsize)
            self._frame_offsets = [[(first + i * nbytes, nbytes)]
                                   for i in range(n_planes)]


class _Series(AbstractPicassoMovie):
    """Movies of several files read as one, in the order of ``maps``."""

    def __init__(self, maps):
        self.maps = maps
        self._cum = np.cumsum([0] + [len(m) for m in maps])

    def __len__(self):
        return int(self._cum[-1])

    @property
    def dtype(self):
        return self.maps[0].dtype

    @property
    def shape(self):
        return (len(self), *self.maps[0].shape[1:])

    def _locate(self, index: int):
        i = int(np.searchsorted(self._cum, index, side="right")) - 1
        return self.maps[i], index - int(self._cum[i])

    def get_frame(self, index: int) -> np.ndarray:
        m, k = self._locate(index)
        return m.get_frame(k)

    def _read_into(self, index: int, out: np.ndarray) -> None:
        m, k = self._locate(index)
        m._read_into(k, out)

    def info(self) -> dict:
        info = self.maps[0].info()
        info["Frames"] = len(self)
        return info

    def close(self):
        for m in self.maps:
            m.close()


def _numbered_siblings(folder: str, pattern: re.Pattern) -> list:
    """(number, path) of the files in ``folder`` whose full path matches
    ``pattern`` (group 1 the number), in numeric order: a lexicographic
    order would put _10 before _2."""
    pairs = []
    for name in os.listdir(folder):
        full = os.path.abspath(os.path.join(folder, name))
        m = pattern.match(full)
        if m:
            pairs.append((int(m.group(1)), full))
    return sorted(pairs)


class STKMultiMovie(_Series):
    """Numbered STK files as one movie (picasso/io.py:1630): a name with
    a numeric suffix joins every sibling of equal or higher suffix, in
    numeric order; a name without one is a single file."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        base, ext = os.path.splitext(self.path)
        m0 = re.match(r"^(.+)_(\d+)$", base)
        paths = [self.path]
        if m0:
            pattern = re.compile(re.escape(m0.group(1)) + r"_(\d+)"
                                 + re.escape(ext) + "$", re.IGNORECASE)
            paths = [p for i, p in _numbered_siblings(
                os.path.dirname(self.path), pattern)
                if i >= int(m0.group(2))] or paths
        super().__init__([STKMovie(p) for p in paths])


class TiffMultiMap(_Series):
    """Numbered TIFF files as one movie (picasso/io.py:1759), named as
    their writers split them: MicroManager's base.ome.tif +
    base_1.ome.tif + ...; NDTiffStack's base.tif + base_1.tif + ...;
    other TIFFs base_N with one extension, where a suffixed name joins
    only the later parts."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        filename = os.path.basename(self.path)
        start = None
        if filename.lower().endswith(".ome.tif"):
            pattern = re.compile(re.escape(self.path[:-len(".ome.tif")])
                                 + r"_(\d+)\.ome\.tif$", re.IGNORECASE)
        else:
            stem, ext = os.path.splitext(self.path)
            if "NDTiffStack" not in filename:
                m0 = re.match(r"^(.+)_(\d+)$", stem)
                if m0:
                    stem, start = m0.group(1), int(m0.group(2))
            pattern = re.compile(re.escape(stem) + r"_(\d+)"
                                 + re.escape(ext) + "$", re.IGNORECASE)
        pairs = [(i, p) for i, p in _numbered_siblings(
            os.path.dirname(self.path), pattern)
            if p != self.path and (start is None or i > start)]
        super().__init__([TiffMap(p) for p in
                          [self.path] + [p for _, p in pairs]])


def load_tif(path: str):
    """A (possibly multi-file) TIFF movie and its info chain
    (picasso/io.py:305)."""
    movie = TiffMultiMap(path)
    return movie, [movie.info()]


def load_stk(path: str):
    """A MetaMorph STK movie, numbered siblings joined
    (picasso/io.py:1447/1630)."""
    movie = STKMultiMovie(path)
    if len(movie.maps) == 1:
        movie = movie.maps[0]
    return movie, [movie.info()]


def _ims_image_attr(file, name):
    """A DataSetInfo/Image attribute stored as a byte array
    (picasso/ext/bitplane.py:135-239)."""
    raw = file["DataSetInfo"]["Image"].attrs[name]
    return "".join(c.decode() if isinstance(c, bytes) else str(c)
                   for c in raw)


class IMSMovie(AbstractPicassoMovie):
    """Bitplane Imaris .ims movie read with h5py, in both layouts the
    reference reads (picasso/ext/bitplane.py:25/:60): one ``TimePoint``
    group a frame with ``Data`` (1, Y, X), or every frame in one ``Data``
    (Z, Y, X) under ``TimePoint 0``. Frames are cropped to the declared
    (Y, X); the pixel size comes from the image extents
    (bitplane.py:240-248)."""

    _RL = "ResolutionLevel 0"

    def __init__(self, path: str, channel: str | None = None):
        import h5py

        self.path = os.path.abspath(path)
        self._f = h5py.File(path, "r")
        try:
            level = self._f["DataSet"][self._RL]
            self._timepoints = sorted(
                level.keys(), key=lambda k: int(k.split("TimePoint ")[1]))
            self.channels = sorted(
                level[self._timepoints[0]].keys(),
                key=lambda k: int(k.split("Channel ")[1]))
            self.set_channel(channel or self.channels[0])
        except Exception as e:
            self._f.close()
            if isinstance(e, ValueError) and "channels" in str(e):
                raise
            raise ValueError(f"{path}: unrecognized IMS layout") from e

    def set_channel(self, channel: str):
        if channel not in self.channels:
            raise ValueError(
                f"{channel!r} not in available channels {self.channels}")
        self.channel = channel
        data = self._f["DataSet"][self._RL][self._timepoints[0]][channel][
            "Data"]
        self._dtype = data.dtype
        try:
            z = int(_ims_image_attr(self._f, "Z"))
        except KeyError:
            z = data.shape[0]
        try:
            self._x = int(_ims_image_attr(self._f, "X"))
            self._y = int(_ims_image_attr(self._f, "Y"))
        except KeyError:
            self._y, self._x = data.shape[1], data.shape[2]
        self._stacked = z > 1 and len(self._timepoints) == 1
        self._n_frames = z if self._stacked else len(self._timepoints)
        self.pixelsize = None
        self.extents = {}
        try:
            for key in ("ExtMin0", "ExtMin1", "ExtMin2",
                        "ExtMax0", "ExtMax1", "ExtMax2"):
                self.extents[key] = float(_ims_image_attr(self._f, key))
            e = self.extents
            px_x = (e["ExtMax0"] - e["ExtMin0"]) / self._x * 1000
            px_y = (e["ExtMax1"] - e["ExtMin1"]) / self._y * 1000
            self.pixelsize = (px_x + px_y) / 2
        except KeyError:
            self.extents = {}

    def __len__(self):
        return self._n_frames

    @property
    def dtype(self):
        return self._dtype

    @property
    def shape(self):
        return (self._n_frames, self._y, self._x)

    def get_frame(self, index):
        level = self._f["DataSet"][self._RL]
        if self._stacked:
            data = level[self._timepoints[0]][self.channel]["Data"]
            return np.asarray(data[index][:self._y, :self._x])
        data = level[self._timepoints[index]][self.channel]["Data"]
        return np.asarray(data[0][:self._y, :self._x])

    def info(self) -> dict:
        """The reference's load_ims info block (picasso/io.py:137-157),
        Height/Width from the frame's rows/columns."""
        info = {
            "Byte Order": "<",
            "Data Type": str(np.dtype(self._dtype)),
            "File": self.path,
            "Frames": self._n_frames,
            "Height": self._y,
            "Width": self._x,
            "Channel": self.channel,
        }
        if self.pixelsize is not None:
            info["Pixelsize"] = self.pixelsize
        for key, value in self.extents.items():
            info["Global" + key] = value
        info["Generated by"] = "IMS Metadata"
        return info

    def close(self):
        self._f.close()


def load_ims(path: str, prompt_info=None):
    """A Bitplane Imaris .ims movie (picasso/io.py:99); on several
    channels ``prompt_info(channels)`` picks one, else ``Channel 0``."""
    movie = IMSMovie(path)
    if len(movie.channels) > 1:
        channel = ("Channel 0" if prompt_info is None
                   else prompt_info(movie.channels))
        print(f"Setting channel to {channel}")
        movie.set_channel(channel)
    return movie, [movie.info()]


def load_ims_all(path: str):
    """Every channel of an .ims movie (picasso/io.py:162): one movie and
    one info chain a channel, extents under the channel's ``Ext*``
    keys."""
    first = IMSMovie(path)
    movies, infos = [], []
    for channel in first.channels:
        movie = (first if channel == first.channel
                 else IMSMovie(path, channel=channel))
        info = movie.info()
        for key in list(info):
            if key.startswith("GlobalExt"):
                info[key[len("Global"):]] = info.pop(key)
        movies.append(movie)
        infos.append([info])
    return movies, infos


def _set_nested(d: dict, keys: list, val) -> None:
    """Set a value deep in a nested dict, making levels as needed
    (picasso/io.py:966)."""
    for key in keys[:-1]:
        if not isinstance(d.get(key), dict):
            d[key] = {}
        d = d[key]
    d[keys[-1]] = val


def nikontext_to_dict(text: str) -> dict:
    """Nikon colon/newline metadata text as a nested dict
    (picasso/io.py:888): a colon-free line opens a level, 'k: v' sets a
    leaf there, 'k: k2: v' opens level k and sets k2, a longer chain
    opens level k and keeps the raw line under k2."""
    out: dict = {}
    curr_keys: list = []
    for item in text.split("\r\n"):
        parts = [p.strip() for p in item.split(":") if p.strip()]
        if len(parts) == 1:
            curr_keys.append(parts[0])
            _set_nested(out, curr_keys, {})
        elif len(parts) == 2:
            _set_nested(out, curr_keys + [parts[0]], parts[1])
        elif len(parts) >= 3:
            curr_keys.append(parts[0])
            _set_nested(out, curr_keys, {})
            _set_nested(out, curr_keys + [parts[1]],
                        parts[2] if len(parts) == 3 else item)
    return out


def nd2_meta_from_text_info(path: str, sizes: dict, dtype_name: str,
                            text_info: dict) -> dict:
    """The movie info of an ND2 file from its ``text_info``
    (picasso/io.py:754-841): the Nikon description text parsed, and the
    camera settings under the 'Picasso Metadata' and 'Micro-Manager
    Metadata' keys that the camera parameters read."""
    mm_info: dict = {}
    for key in ("capturing", "description", "optics"):
        if key in text_info:
            try:
                mm_info[key] = nikontext_to_dict(text_info[key])
            except Exception:
                pass
    if "date" in text_info:
        mm_info["AcquisitionDate"] = text_info["date"]
    meta = mm_info.get("description", {}).get("Metadata", {})
    cam = meta.get("Camera Settings", {})
    camera_name = str(meta.get("Camera Name", "None"))
    readout_rate = str(cam.get("Readout Rate", "None"))
    readout_mode = str(cam.get("Readout Mode", "None"))
    conversion_gain = str(cam.get("Conversion Gain", "None"))
    filter_ = str(cam.get("Microscope Settings", {}).get(
        "Nikon Ti2, FilterChanger(Turret-Lo)", "None"))
    return {
        "File": path,
        "Height": sizes["Y"],
        "Width": sizes["X"],
        "Data Type": dtype_name,
        "Frames": sizes["T"],
        "Acquisition Comments": "",
        "Camera": camera_name,
        "Micro-Manager Metadata": {
            camera_name + "-PixelReadoutRate": readout_rate,
            camera_name + "-Sensitivity/DynamicRange": (
                readout_mode + " " + conversion_gain),
            "Filter": filter_,
        },
        "Picasso Metadata": {
            "Camera": camera_name,
            "PixelReadoutRate": readout_rate,
            "ReadoutMode": readout_mode,
            "ConversionGain": conversion_gain,
            "Filter": filter_,
        },
        "nd2 Metadata": mm_info,
    }


def nd2_camera_parameters(meta: dict, config: dict) -> dict:
    """Gain/QE/wavelength/sensitivity settings of an ND2 movie from the
    camera config (picasso/io.py:1028): the config needs 'Cameras' and
    the metadata 'Camera', one listed in the other; without 'Picasso
    Metadata' unit gain and QE; 'Sensitivity Categories' read from the
    Picasso Metadata; 'Quantum Efficiency' + 'Filter Wavelengths' map
    the active filter to its wavelength and QE."""
    if "Cameras" not in config or "Camera" not in meta:
        raise KeyError("'camera' key not found in metadata or config.")
    cameras = config["Cameras"]
    camera = meta["Camera"]
    if camera not in cameras:
        raise KeyError("camera from metadata not found in config.")
    parameters: dict = {"cam_index": sorted(cameras).index(camera),
                        "camera": camera}
    if "Picasso Metadata" not in meta:
        return {"gain": [1], "qe": [1], "wavelength": [0], "cam_index": 0}
    pm_info = meta["Picasso Metadata"]
    cam_config = cameras[camera]
    if "Gain Property Name" in cam_config:
        raise NotImplementedError(
            "Extracting Gain from nd2 files is not implemented yet.")
    parameters["gain"] = [1]
    parameters["Sensitivity"] = {
        c: pm_info[c] for c in cam_config.get("Sensitivity Categories", [])}
    if "Quantum Efficiency" in cam_config:
        channel = pm_info.get("Filter")
        wavelengths = cam_config.get("Filter Wavelengths", {})
        if channel in wavelengths:
            wavelength = wavelengths[channel]
            parameters["wavelength"] = str(wavelength)
            parameters["qe"] = cam_config["Quantum Efficiency"][wavelength]
    parameters.setdefault("qe", [1])
    parameters.setdefault("wavelength", [0])
    return parameters


class ND2Movie(AbstractPicassoMovie):
    """Nikon .nd2 movie through the optional ``nd2`` package
    (picasso/io.py:713), of exactly the dimensions (T, Y, X). Raises
    ImportError when ``nd2`` is not installed."""

    def __init__(self, path: str):
        try:
            import nd2
        except ImportError as e:
            raise ImportError(
                "ND2 support requires the optional 'nd2' package, which is "
                "not installed in this environment.") from e
        self.path = os.path.abspath(path)
        self._file = nd2.ND2File(path)
        self._sizes = dict(self._file.sizes)
        if set(self._sizes) != {"T", "Y", "X"}:
            self._file.close()
            raise KeyError(f"File {self.path} has dimensions "
                           f"{list(self._sizes)} but should have exactly "
                           "['T', 'Y', 'X'].")
        self._meta = None

    def __len__(self):
        return self._sizes["T"]

    @property
    def dtype(self):
        return self._file.dtype

    @property
    def shape(self):
        return (self._sizes["T"], self._sizes["Y"], self._sizes["X"])

    def get_frame(self, index):
        return np.asarray(self._file.read_frame(int(index)))

    def info(self) -> dict:
        return self.meta

    @property
    def meta(self) -> dict:
        if self._meta is None:
            try:
                text_info = dict(self._file.text_info)
            except Exception:
                text_info = {}
            self._meta = nd2_meta_from_text_info(
                self.path, self._sizes, np.dtype(self.dtype).name, text_info)
        return self._meta

    def camera_parameters(self, config: dict) -> dict:
        return nd2_camera_parameters(self.meta, config)

    def close(self):
        self._file.close()


def load_nd2(path: str):
    """A Nikon .nd2 movie (picasso/io.py:967); needs ``nd2``."""
    movie = ND2Movie(path)
    return movie, [movie.info()]


def load_movie(path: str, prompt_info=None):
    """A movie and its info chain, by extension (picasso/io.py:336)."""
    ext = os.path.splitext(path)[1].lower()
    loaders = {".raw": load_raw, ".tif": load_tif, ".tiff": load_tif,
               ".ims": lambda p: load_ims(p, prompt_info=prompt_info),
               ".nd2": load_nd2, ".stk": load_stk}
    if ext not in loaders:
        raise ValueError(f"Unsupported movie format: {ext}")
    return loaders[ext](path)


# --- raw conversion ---------------------------------------------------------


def save_raw(path: str, movie: np.ndarray, info: list[dict]) -> None:
    """A movie as flat raw binary plus its YAML sidecar."""
    np.ascontiguousarray(movie).tofile(path)
    save_info(os.path.splitext(path)[0] + ".yaml", info)


def get_movie_groups(paths: list[str]) -> dict[str, list[str]]:
    """TIFF paths grouped into their multi-file series, keyed by the
    name without the numeric suffix."""
    groups: dict[str, list[str]] = {}
    for path in sorted(paths):
        base = re.sub(r"_(\d+)(?=\.[^.]+$)", "", path)
        groups.setdefault(base, []).append(path)
    return groups


def to_raw_combined(basename: str, paths: list[str]) -> None:
    """The TIFF files ``paths`` concatenated into one ``.ome.raw`` +
    YAML named after ``basename``; each file is read alone, since a
    TiffMultiMap would join the whole series again for every member."""
    raw_path = os.path.splitext(basename)[0] + ".ome.raw"
    info, n_frames = None, 0
    with open(raw_path, "wb") as fh:
        for path in paths:
            movie = TiffMap(path)
            try:
                movie.tofile(fh, "<")
                minfo = movie.info()
            finally:
                movie.close()
            n_frames += minfo["Frames"]
            info = info or minfo
    info["Frames"] = n_frames
    info["Generated by"] = f"Picasso v{__version__} ToRaw"
    info["Byte Order"] = "<"
    info["Raw File"] = raw_path
    save_info(os.path.splitext(raw_path)[0] + ".yaml", [info])


def to_raw(path: str, verbose: bool = True) -> None:
    """Convert the TIFF files matching a pattern to raw, one file per
    series (picasso/io.py:2043)."""
    groups = get_movie_groups(glob.glob(path))
    for i, (basename, group) in enumerate(groups.items()):
        if verbose:
            print(f"Converting movie {i + 1}/{len(groups)}...", end="\r")
        to_raw_combined(basename, group)
    if verbose and groups:
        print()


# --- localization tables ----------------------------------------------------


def save_locs(path: str, locs: np.ndarray, info: list[dict]) -> None:
    """Save a locs structured array as the HDF5 ``"locs"`` dataset plus
    the YAML info chain; ``ensure_sanity`` runs first, like the
    reference (picasso/io.py:2089)."""
    import h5py

    locs = lib.ensure_sanity(locs, info)
    with h5py.File(path, "w") as f:
        f.create_dataset("locs", data=locs)
    save_info(os.path.splitext(path)[0] + ".yaml", info)


def load_locs(path: str):
    """A locs table (.hdf5 ``"locs"`` dataset) and its info chain, after
    ``ensure_sanity`` (picasso/io.py:2113)."""
    import h5py

    with h5py.File(path, "r") as f:
        if "locs" not in f:
            raise KeyError(f"File {path} does not contain a 'locs' dataset.")
        locs = f["locs"][()]
    info = load_info(path)
    return lib.ensure_sanity(locs, info), info


def load_clusters(path: str) -> np.ndarray:
    """A clusters table saved under a ``"clusters"`` or, failing that, a
    ``"locs"`` dataset (picasso/io.py:2234), without a sanity filter."""
    import h5py

    with h5py.File(path, "r") as f:
        for key in ("clusters", "locs"):
            if key in f:
                return f[key][()]
    raise KeyError(f"File {path} does not contain a 'locs' dataset.")


def save_datasets(path: str, info: list[dict], **kwargs) -> None:
    """Several structured arrays as named HDF5 datasets of one file, plus
    the YAML info chain (picasso/io.py:2065)."""
    import h5py

    with h5py.File(path, "w") as f:
        for key, val in kwargs.items():
            f.create_dataset(key, data=val)
    save_info(os.path.splitext(path)[0] + ".yaml", info)


def load_picks(path: str, pixelsize: float | None = None):
    """Pick regions from a Render picks file (picasso/io.py:446):
    (picks, shape, size in camera px, None for polygons). A size saved
    in nm is divided by ``pixelsize`` (1 if not given); a file with
    centres and a diameter but no shape holds circles."""
    import yaml

    if not path.endswith(".yaml"):
        raise AssertionError("Picks should be stored in a .yaml file.")
    with open(path, "r") as f:
        regions = yaml.full_load(f)
    if "Shape" in regions:
        shape = regions["Shape"]
    elif "Centers" in regions and "Diameter" in regions:
        shape = "Circle"
    else:
        raise ValueError("Unrecognized picks file")
    pixelsize = 1 if pixelsize is None else pixelsize
    size = None
    if shape == "Circle":
        picks = regions["Centers"]
        size = (regions["Diameter (nm)"] / pixelsize
                if "Diameter (nm)" in regions else regions["Diameter"])
    elif shape == "Rectangle":
        picks = regions["Center-Axis-Points"]
        size = (regions["Width (nm)"] / pixelsize
                if "Width (nm)" in regions else regions["Width"])
    elif shape == "Polygon":
        picks = regions["Vertices"]
    elif shape == "Square":
        picks = regions["Centers"]
        size = regions["Side Length (nm)"] / pixelsize
    else:
        raise ValueError("Unrecognized pick shape")
    return picks, shape, size


#: the picks file's keys of each shape: (picks, size in nm)
_PICK_KEYS = {"Circle": ("Centers", "Diameter (nm)"),
              "Rectangle": ("Center-Axis-Points", "Width (nm)"),
              "Polygon": ("Vertices", None),
              "Square": ("Centers", "Side Length (nm)")}


def save_picks(path: str, picks: list, shape: str,
               size: float | None = None, pixelsize: float = 1.0) -> None:
    """Pick regions as the Render picks file that :func:`load_picks`
    reads (picasso/io.py:248), the size in nm."""
    import yaml

    if shape not in _PICK_KEYS:
        raise ValueError("Unrecognized pick shape")
    key, size_key = _PICK_KEYS[shape]
    regions = {key: picks}
    if size_key is not None:
        regions[size_key] = size * pixelsize
    regions["Shape"] = shape
    with open(path, "w") as f:
        yaml.dump(regions, f)


def save_drift(path: str, drift: np.ndarray) -> None:
    """Per-frame drift (fields x, y) as CRLF-terminated text, one row
    "x y" per frame (picasso/io.py:514)."""
    np.savetxt(path, np.column_stack([drift[n] for n in drift.dtype.names]),
               newline="\r\n")


def load_drift(path: str) -> np.ndarray:
    """Per-frame drift from a text file of 2 or 3 columns (picasso/
    io.py:528): a structured array with fields x, y (and z), f64. Raises
    ValueError for a name that does not end in ``.txt`` or another
    shape."""
    if not path.endswith(".txt"):
        raise ValueError("Drift file must end with .txt")
    drift = np.loadtxt(path, delimiter=" ")
    if drift.ndim != 2 or drift.shape[1] not in (2, 3):
        raise ValueError(
            "Drift must be a 2D array with 2 or 3 columns (x, y, (z)). "
            f"Loaded array has shape {drift.shape}."
        )
    out = np.empty(len(drift), [(c, np.float64) for c in ("x", "y", "z")
                                [:drift.shape[1]]])
    for i, c in enumerate(out.dtype.names):
        out[c] = drift[:, i]
    return out


def generated_by(step: str) -> dict:
    """The provenance block each pipeline stage appends to the info
    chain: {"Generated by": "Picasso v<version> <step>"}."""
    return {"Generated by": f"Picasso v{__version__} {step}"}


def _read_dataset(path: str, key: str) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        if key not in f:
            raise KeyError(f"File {path} does not contain a '{key}' dataset.")
        return f[key][()]


def save_identifications(path: str, identifications: np.ndarray,
                         info: list[dict]) -> None:
    """Spot identifications (a structured array) as the HDF5
    ``"identifications"`` dataset plus the YAML info chain
    (picasso/io.py:2167)."""
    save_datasets(path, info, identifications=identifications)


def load_identifications(path: str):
    """The identifications and info chain that
    :func:`save_identifications` wrote (picasso/io.py:2191)."""
    return _read_dataset(path, "identifications"), load_info(path)


def _spots_ext(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".npy", ".tif", ".tiff"):
        raise ValueError(
            f"Unsupported spots format '{ext}'; use .npy or .tif.")
    return ext


def save_spots(path: str, spots: np.ndarray, info: list[dict]) -> None:
    """Cut spot ROIs (N, box, box) as .npy, or as a multi-page f32 .tif
    through imageio, with a YAML info sidecar (the Localize GUI's "Save
    spots", picasso/gui/localize.py:2762)."""
    if _spots_ext(path) == ".npy":
        np.save(path, spots)
    else:
        import warnings

        import imageio

        with warnings.catch_warnings():
            # imageio's bundled tifffile warns about its own deprecation
            warnings.simplefilter("ignore", DeprecationWarning)
            imageio.mimwrite(path, np.asarray(spots, np.float32))
    save_info(os.path.splitext(path)[0] + ".yaml", info)


def load_spots(path: str):
    """The spot ROIs and info chain that :func:`save_spots` wrote."""
    if _spots_ext(path) == ".npy":
        spots = np.load(path)
    else:
        import warnings

        import imageio

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            spots = np.asarray(imageio.mimread(path))
    return spots, load_info(path)


def load_filter(path: str):
    """A locs-like table from the first of the datasets ``"locs"``,
    ``"groups"`` and ``"clusters"`` that the file holds, without a sanity
    filter, and its info chain (picasso/io.py:2260)."""
    for key in ("locs", "groups", "clusters"):
        try:
            return _read_dataset(path, key), load_info(path)
        except KeyError:
            continue
    raise KeyError(f"No recognized dataset in {path}.")


def load_calibration(path: str) -> dict:
    """A 3D astigmatism calibration YAML; KeyError without its X or Y
    coefficients (picasso/io.py:249)."""
    import yaml

    with open(path, "r") as f:
        calibration = yaml.full_load(f)
    for key in ("X Coefficients", "Y Coefficients"):
        if key not in calibration:
            raise KeyError(f"Calibration file is missing '{key}'; not a "
                           "valid 3D calibration.")
    return calibration


def load_mask(path: str):
    """A SPINNA density mask (.npy) normalised to sum 1 in f64, and the
    first block of its info; TypeError for a mask SPINNA did not make
    (picasso/io.py:411)."""
    mask = np.float64(np.load(path))
    mask = mask / mask.sum()
    info = load_info(os.path.splitext(path)[0] + ".yaml")[0]
    if "SPINNA" not in info.get("Generated by", ""):
        raise TypeError("Please load a mask provided by Picasso SPINNA")
    return mask, info


# --- user settings and the camera config ------------------------------------


def _user_settings_filename() -> str:
    return os.path.join(os.path.expanduser("~"), ".picasso", "settings.yaml")


def _to_autodict(d: dict) -> lib.AutoDict:
    out = lib.AutoDict()
    for k, v in d.items():
        out[k] = _to_autodict(v) if isinstance(v, dict) else v
    return out


def _to_dict(node: dict) -> dict:
    return {k: _to_dict(v) if isinstance(v, dict) else v
            for k, v in node.items()}


def load_user_settings() -> lib.AutoDict:
    """~/.picasso/settings.yaml as nested AutoDicts, empty if there is
    none (picasso/io.py:564)."""
    import yaml

    try:
        with open(_user_settings_filename(), "r") as f:
            settings = yaml.full_load(f)
    except FileNotFoundError:
        settings = None
    return _to_autodict(settings or {})


def save_user_settings(settings: dict) -> None:
    """Write the user settings to ~/.picasso/settings.yaml as plain
    nested dicts (picasso/io.py:620)."""
    import yaml

    filename = _user_settings_filename()
    os.makedirs(os.path.dirname(filename), exist_ok=True)
    with open(filename, "w") as f:
        yaml.dump(_to_dict(settings), f, default_flow_style=False)


def _config_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "config.yaml")


def save_config(CONFIG: dict) -> None:
    """The camera config as ``config.yaml`` beside the package
    (picasso/io.py:217)."""
    import yaml

    with open(_config_path(), "w") as f:
        yaml.dump(CONFIG, f, default_flow_style=False)


def load_config() -> dict:
    """The camera config that :func:`save_config` wrote, or {}."""
    import yaml

    try:
        with open(_config_path(), "r") as f:
            return yaml.full_load(f) or {}
    except FileNotFoundError:
        return {}


# --- Bitplane Imaris --------------------------------------------------------


def _ims_attr(value) -> np.ndarray:
    """A value as Imaris' byte-array string attribute (as
    :func:`_ims_image_attr` reads it)."""
    return np.frombuffer(str(value).encode(), dtype="|S1").copy()


def _ims_write_info(f, *, x, y, z, n_channels, n_timepoints, extents,
                    channel_names):
    """The DataSetInfo groups of Imaris 5.5's HDF5 layout."""
    for k, v in {"ImarisDataSet": "ImarisDataSet", "ImarisVersion": "5.5.0",
                 "DataSetDirectoryName": "DataSet",
                 "DataSetInfoDirectoryName": "DataSetInfo",
                 "ThumbnailDirectoryName": "Thumbnail"}.items():
        f.attrs[k] = _ims_attr(v)
    f.attrs["NumberOfDataSets"] = np.uint32(1)
    dsi = f.create_group("DataSetInfo")
    img = dsi.create_group("Image")
    for k, v in (("X", x), ("Y", y), ("Z", z), ("Noc", n_channels),
                 ("Unit", "um"), *extents.items(),
                 ("Description", "picasso_torch export")):
        img.attrs[k] = _ims_attr(v)
    colors = {"Red": "1.000 0.000 0.000", "Green": "0.000 1.000 0.000",
              "Blue": "0.000 0.000 1.000"}
    for ci, name in enumerate(channel_names):
        ch = dsi.create_group(f"Channel {ci}")
        ch.attrs["Name"] = _ims_attr(name)
        ch.attrs["ColorMode"] = _ims_attr("BaseColor")
        ch.attrs["ColorOpacity"] = _ims_attr("1.000")
        ch.attrs["Color"] = _ims_attr(colors.get(name, "1.000 1.000 1.000"))
    tinfo = dsi.create_group("TimeInfo")
    tinfo.attrs["DatasetTimePoints"] = _ims_attr(n_timepoints)
    tinfo.attrs["FileTimePoints"] = _ims_attr(n_timepoints)
    for t in range(n_timepoints):
        tinfo.attrs[f"TimePoint{t + 1}"] = _ims_attr(
            f"2000-01-01 00:00:{t % 60:02d}.000")
    f.create_group("Thumbnail")


def _ims_write_block(group, data) -> None:
    """One channel block: the gzip'd ``Data`` with its size and
    histogram attributes."""
    group.create_dataset("Data", data=data, compression="gzip",
                         compression_opts=2, chunks=True)
    z, y, x = data.shape
    group.attrs["ImageSizeX"] = _ims_attr(x)
    group.attrs["ImageSizeY"] = _ims_attr(y)
    group.attrs["ImageSizeZ"] = _ims_attr(z)
    group.attrs["HistogramMin"] = _ims_attr(f"{float(data.min()):.3f}")
    group.attrs["HistogramMax"] = _ims_attr(f"{float(data.max()):.3f}")


def write_ims(path: str, movie, info: list[dict] | None = None, *,
              pixelsize: float | None = None, channel_name: str = "Red",
              stacked: bool = False) -> None:
    """A (T, Y, X) movie as a Bitplane Imaris ``.ims`` file with h5py
    (the reference's ImarisWriter, picasso/ext/bitplane.py:323): one
    ``TimePoint`` group a frame with (1, Y, X) blocks, or with
    ``stacked`` all frames as one z-stack under ``TimePoint 0``, the two
    layouts :class:`IMSMovie` reads. Extents in um from the pixel size
    (the info's, else 130 nm; bitplane.py:399-404)."""
    import h5py

    movie = np.asarray(movie)
    if movie.ndim != 3:
        raise ValueError("movie must be (frames, Y, X)")
    T, Y, X = movie.shape
    if pixelsize is None and info:
        pixelsize = lib.get_from_metadata(info, "Pixelsize", default=None)
    px_um = (pixelsize or 130.0) / 1000.0
    z = T if stacked else 1
    extents = {"ExtMin0": 0.0, "ExtMin1": 0.0, "ExtMin2": -z * px_um / 2,
               "ExtMax0": X * px_um, "ExtMax1": Y * px_um,
               "ExtMax2": z * px_um / 2}
    with h5py.File(path, "w") as f:
        _ims_write_info(f, x=X, y=Y, z=z, n_channels=1,
                        n_timepoints=1 if stacked else T, extents=extents,
                        channel_names=[channel_name])
        level = f.create_group("DataSet").create_group("ResolutionLevel 0")
        if stacked:
            _ims_write_block(level.create_group("TimePoint 0").create_group(
                "Channel 0"), movie)
        else:
            for t in range(T):
                _ims_write_block(level.create_group(
                    f"TimePoint {t}").create_group("Channel 0"),
                    movie[t:t + 1])


def numpy_to_imaris(array: np.ndarray, filename: str, colors,
                    oversampling: float, viewport, info: list[dict],
                    z_min: float, z_max: float, pixelsize: float) -> None:
    """A rendered (C, Z, Y, X) or (C, Y, X) volume as an Imaris file, one
    channel a colour name (picasso/ext/bitplane.py:323; extents as
    bitplane.py:399-428)."""
    import h5py

    array = np.asarray(array)
    if array.ndim == 3:
        array = array[:, None, :, :]
    C, Z, Y, X = array.shape
    (y_min, x_min), (y_max, x_max) = viewport
    first = info[0] if info else {}
    x_0 = x_min * pixelsize / 1000 + first.get("ExtMin0", 0.0)
    y_0 = y_min * pixelsize / 1000 + first.get("ExtMin1", 0.0)
    x_1 = x_max * pixelsize / 1000 + first.get("ExtMin0", 0.0)
    y_1 = y_max * pixelsize / 1000 + first.get("ExtMin1", 0.0)
    z_base = (first.get("ExtMin2", 0.0) + first.get("ExtMax2", 0.0)) / 2
    if z_min == z_max == 0:
        z_0 = z_base - (Z / 2) * pixelsize / 1000 / oversampling
        z_1 = z_base + (Z / 2) * pixelsize / 1000 / oversampling
    else:
        z_0 = z_base + z_min / 1000
        z_1 = z_base + z_max / 1000
    extents = {"ExtMin0": x_0, "ExtMin1": y_0, "ExtMin2": z_0,
               "ExtMax0": x_1, "ExtMax1": y_1, "ExtMax2": z_1}
    with h5py.File(filename, "w") as f:
        _ims_write_info(f, x=X, y=Y, z=Z, n_channels=C, n_timepoints=1,
                        extents=extents, channel_names=list(colors))
        tp = f.create_group("DataSet").create_group(
            "ResolutionLevel 0").create_group("TimePoint 0")
        for ci in range(C):
            _ims_write_block(tp.create_group(f"Channel {ci}"), array[ci])


# --- exporters and the ThunderSTORM import (picasso/io.py:2291-2538) --------


def _savetxt(f, cols, fmt: list[str], delimiter: str = " ") -> None:
    """np.savetxt(f, column_stack(cols), fmt, delimiter, newline="\\r\\n")
    into a binary file: the same bytes (each row ``fmt % row``, the cells
    as Python numbers equal to numpy's), formatted from lists, which is
    several times faster than savetxt's loop over numpy rows."""
    row = delimiter.join(fmt) + "\r\n"
    f.write("".join(row % r for r in zip(*(np.asarray(c).tolist()
                                           for c in cols))).encode("latin1"))


def export_ts(path: str, locs: np.ndarray, info: list[dict]) -> None:
    """The locs as a ThunderSTORM CSV (picasso/io.py:2291): id, frame
    from 1, x and y in nm, z as the table holds it, the sigmas, photons,
    background and the mean lateral precision in nm, each column in its
    dtype as pandas writes it."""
    pixelsize = lib.get_from_metadata(info, "Pixelsize", 130)
    names = locs.dtype.names
    out = {"id": np.arange(len(locs)), "frame": locs["frame"] + 1,
           "x [nm]": locs["x"] * pixelsize, "y [nm]": locs["y"] * pixelsize}
    if "z" in names:
        out["z [nm]"] = locs["z"]
    if "sx" in names:
        out["sigma_x [nm]"] = locs["sx"] * pixelsize
        out["sigma_y [nm]"] = locs["sy"] * pixelsize
        out["sigma [nm]"] = (locs["sx"] + locs["sy"]) / 2 * pixelsize
    if "photons" in names:
        out["intensity [photon]"] = locs["photons"]
    if "bg" in names:
        out["offset [photon]"] = locs["bg"]
    if "lpx" in names:
        out["uncertainty_xy [nm]"] = ((locs["lpx"] + locs["lpy"]) / 2
                                      * pixelsize)
    lib.write_table(path, out)


def export_thunderstorm(path, locs, info):
    """:func:`export_ts` under the reference's name."""
    export_ts(path, locs, info)


def export_txt_imagej(path: str, locs: np.ndarray, info=None) -> None:
    """frame, x, y as text for ImageJ, three spaces apart, CRLF lines
    (picasso/io.py:2380)."""
    with open(path, "wb") as f:
        _savetxt(f, [locs[c] for c in ("frame", "x", "y")],
                 ["%.1i", "%.5f", "%.5f"], "   ")


def export_txt_nis(path: str, locs: np.ndarray, info: list[dict]) -> None:
    """Tab-separated text for NIS Elements with a header, CRLF lines
    (picasso/io.py:2410): X, Y (and Z) and Width in nm, background and
    photons rounded half to even, frames from 1; every cell formatted
    from the table's common dtype, as pandas' to_numpy gives it."""
    pixelsize = lib.get_from_metadata(info, "Pixelsize", raise_error=True)
    has_z = "z" in locs.dtype.names
    one = np.ones(len(locs), np.int64)
    cols = {"X": locs["x"] * pixelsize, "Y": locs["y"] * pixelsize}
    if has_z:
        cols["Z"] = locs["z"]
    cols.update(Channel=one, Width=locs["sx"] * pixelsize,
                BG=np.round(locs["bg"]).astype(int), Length=one,
                Area=np.round(locs["photons"]).astype(int),
                Frame=locs["frame"].astype(int) + 1)
    dtype = np.result_type(*cols.values())
    fmt = (["%.2f", "%.2f"] + (["%.2f"] if has_z else [])
           + ["%.i", "%.2f", "%.i", "%.i", "%.i", "%.i"])
    with open(path, "wb") as f:
        f.write("\t".join(cols).encode() + b"\r\n")
        _savetxt(f, [c.astype(dtype) for c in cols.values()], fmt, "\t")


def _xyz_or_warn(locs: np.ndarray, target: str) -> bool:
    if "z" not in locs.dtype.names:
        import warnings

        warnings.warn(f"No z coordinate found; cannot export to {target}.")
        return False
    return True


def export_xyz_chimera(path: str, locs: np.ndarray, info: list[dict]) -> None:
    """Molecule, x, y (nm) and z, tab-separated for Chimera, CRLF lines
    (picasso/io.py:2460); without z it warns and writes nothing."""
    pixelsize = lib.get_from_metadata(info, "Pixelsize", raise_error=True)
    if not _xyz_or_warn(locs, ".xyz for Chimera"):
        return
    out = [np.ones(len(locs)), locs["x"] * pixelsize, locs["y"] * pixelsize,
           locs["z"]]
    dtype = np.result_type(*out)
    with open(path, "wb") as f:
        f.write(b"Molecule export\r\n")
        _savetxt(f, [c.astype(dtype) for c in out],
                 ["%i", "%.5f", "%.5f", "%.5f"], "\t")


def export_3d_visp(path: str, locs: np.ndarray, info: list[dict]) -> None:
    """x, y (nm), z, photons and frame for ViSP, CRLF lines
    (picasso/io.py:2500); without z it warns and writes nothing."""
    pixelsize = lib.get_from_metadata(info, "Pixelsize", raise_error=True)
    if not _xyz_or_warn(locs, ".3d for ViSP"):
        return
    out = [locs["x"] * pixelsize, locs["y"] * pixelsize, locs["z"],
           locs["photons"], locs["frame"].astype(int)]
    dtype = np.result_type(*out)
    with open(path, "wb") as f:
        _savetxt(f, [c.astype(dtype) for c in out],
                 ["%.1f", "%.1f", "%.1f", "%.1f", "%d"])


# the ThunderSTORM columns import_ts reads: (column, field, scale by 1 /
# pixel size), in the order the fields are added
_TS_COLUMNS = (("intensity [photon]", "photons", False),
               ("offset [photon]", "bg", False),
               ("sigma_x [nm]", "sx", True), ("sigma_y [nm]", "sy", True),
               ("sigma [nm]", "sx", True),
               ("uncertainty_xy [nm]", "lpx", True))


def _read_ts(path: str) -> dict[str, np.ndarray]:
    """A CSV's columns by header name, as f64 (an empty cell NaN)."""
    import csv
    from io import StringIO

    with open(path, newline="") as f:
        header = next(csv.reader(f))
        body = f.read()
    if not body.strip():
        table = np.empty((0, len(header)))
    else:
        try:
            table = np.loadtxt(StringIO(body), delimiter=",", quotechar='"',
                               ndmin=2)
        except ValueError:  # empty cells, which pandas reads as NaN
            table = np.array([[float(v) if v.strip() else np.nan
                               for v in row]
                              for row in csv.reader(StringIO(body))])
    return {name: table[:, i] for i, name in enumerate(header)}


def import_ts(path: str, pixelsize: float = 130.0):
    """A ThunderSTORM CSV as a locs table (picasso/io.py:2539): frame from
    0 (uint32), x and y in camera pixels and photons, bg, sx, sy, lpx,
    lpy where the CSV has them (f32; sy and lpy copied from sx and lpx
    where it has one sigma or precision), with an info block of the
    field's size. z is not read."""
    ts = _read_ts(path)
    cols = {"frame": (ts["frame"] - 1).astype(np.uint32),
            "x": (ts["x [nm]"] / pixelsize).astype(np.float32),
            "y": (ts["y [nm]"] / pixelsize).astype(np.float32)}
    for src, dst, scaled in _TS_COLUMNS:
        if src in ts and dst not in cols:
            cols[dst] = (ts[src] * (1 / pixelsize if scaled else 1.0)).astype(
                np.float32)
    if "sx" in cols and "sy" not in cols:
        cols["sy"] = cols["sx"]
    if "lpx" in cols and "lpy" not in cols:
        cols["lpy"] = cols["lpx"]
    locs = np.empty(len(cols["x"]), [(k, v.dtype) for k, v in cols.items()])
    for k, v in cols.items():
        locs[k] = v
    n = len(locs)
    info = [{
        "Frames": int(locs["frame"].max()) + 1 if n else 0,
        "Height": int(np.ceil(locs["y"].max())) + 1 if n else 1,
        "Width": int(np.ceil(locs["x"].max())) + 1 if n else 1,
        "Pixelsize": pixelsize,
        "Generated by": f"Picasso v{__version__} ImportTS",
    }]
    return locs, info
