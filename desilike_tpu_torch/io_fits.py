"""Minimal FITS reader/writer (no fitsio/astropy dependency).

A numpy-only copy of ``desilike_tpu/io_fits.py``, for the port's CMB
readers and writers. Supports the subset of FITS the Planck likelihood
products use (the ``fitsio.read(..., ext=n)`` calls of the hillipop,
lollipop and planck2018 readers):

- primary + IMAGE extension HDUs with BITPIX 8/16/32/64/-32/-64,
- BINTABLE extension HDUs with scalar columns of types L/B/I/J/K/E/D,
- header cards with string / logical / numeric values (HIERARCH, CONTINUE,
  comment-only cards and the undefined value are tolerated on read).

Not supported (not needed by any consumed product): random groups,
variable-length arrays, vector columns (repeat > 1), ASCII tables,
scaling keywords (BSCALE/BZERO) other than identity.

The API mirrors the two fitsio entry points the reference uses::

    read(filename, ext=0)         -> ndarray (image) or dict of columns
    read_header(filename, ext=0)  -> dict
    write(filename, hdus)         -> hdus = [Hdu(data=...), Hdu(columns=...)]

Endianness: FITS is big-endian on disk; arrays are returned native-order.
"""

import os

import numpy as np

__all__ = ['Hdu', 'read', 'read_header', 'write']

BLOCK = 2880
CARD = 80

# FITS binary-table TFORM letter <-> numpy dtype (scalar columns only)
_TFORM2DTYPE = {'L': '?', 'B': 'u1', 'I': '>i2', 'J': '>i4', 'K': '>i8',
                'E': '>f4', 'D': '>f8'}
_DTYPE2TFORM = {'b1': 'L', 'u1': 'B', 'i2': 'I', 'i4': 'J', 'i8': 'K',
                'f4': 'E', 'f8': 'D'}
_BITPIX2DTYPE = {8: 'u1', 16: '>i2', 32: '>i4', 64: '>i8',
                 -32: '>f4', -64: '>f8'}


class Hdu(object):
    """One header-data unit: ``data`` (ndarray image), or ``columns``
    (ordered {name: 1-D array}) for a binary table; ``header`` extra cards."""

    def __init__(self, data=None, columns=None, header=None):
        if data is not None and columns is not None:
            raise ValueError('an HDU is either an image or a table, not both')
        self.data = None if data is None else np.asarray(data)
        self.columns = None if columns is None else dict(columns)
        self.header = dict(header or {})

    def __getitem__(self, name):  # fitsio-style hdu['LMIN'][:] access
        return self.columns[name]

    def read_header(self):
        return self.header


def _parse_value(raw):
    raw = raw.strip()
    if not raw:
        return None
    if raw.startswith("'"):  # FITS string: quotes doubled inside
        end = 1
        while True:
            end = raw.index("'", end)
            if raw[end + 1:end + 2] == "'":
                end += 2
                continue
            break
        return raw[1:end].replace("''", "'").rstrip()
    if raw in ('T', 'F'):
        return raw == 'T'
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw.replace('D', 'E').replace('d', 'e'))
    except ValueError:
        return raw


def _read_header_block(fh):
    """Consume 2880-byte records until END; return (cards dict, data offset)."""
    cards = {}
    while True:
        block = fh.read(BLOCK)
        if len(block) < BLOCK:
            raise EOFError('truncated FITS header')
        text = block.decode('ascii', errors='replace')
        done = False
        for i in range(0, BLOCK, CARD):
            card = text[i:i + CARD]
            key = card[:8].strip()
            if key == 'END':
                done = True
                break
            if key in ('', 'COMMENT', 'HISTORY') or card[8:10] != '= ':
                continue
            body = card[10:]
            # strip inline comment (a '/' outside any quoted string)
            inq = False
            for j, ch in enumerate(body):
                if ch == "'":
                    inq = not inq
                elif ch == '/' and not inq:
                    body = body[:j]
                    break
            cards[key] = _parse_value(body)
        if done:
            return cards


def _data_size(cards):
    naxis = int(cards.get('NAXIS', 0))
    if naxis == 0:
        return 0, ()
    shape = tuple(int(cards['NAXIS{:d}'.format(i)]) for i in range(1, naxis + 1))
    nbytes = abs(int(cards['BITPIX'])) // 8
    for n in shape:
        nbytes *= n
    nbytes += int(cards.get('PCOUNT', 0)) * (abs(int(cards['BITPIX'])) // 8)
    return nbytes, shape[::-1]  # FITS axes are Fortran-ordered


def _read_hdu(fh):
    cards = _read_header_block(fh)
    nbytes, shape = _data_size(cards)
    raw = fh.read((nbytes + BLOCK - 1) // BLOCK * BLOCK)[:nbytes] if nbytes else b''
    xtension = str(cards.get('XTENSION', '')).strip()
    if xtension == 'BINTABLE':
        nrows = shape[0] if shape else 0
        tfields = int(cards.get('TFIELDS', 0))
        names, formats = [], []
        for i in range(1, tfields + 1):
            names.append(str(cards.get('TTYPE{:d}'.format(i), 'col{:d}'.format(i))).strip())
            tform = str(cards['TFORM{:d}'.format(i)]).strip()
            repeat = tform[:-1] or '1'
            if tform[-1] not in _TFORM2DTYPE or int(repeat) != 1:
                raise NotImplementedError('unsupported TFORM {!r}'.format(tform))
            formats.append(_TFORM2DTYPE[tform[-1]])
        rec = np.frombuffer(raw, dtype=np.dtype({'names': names, 'formats': formats}),
                            count=nrows)
        columns = {n: np.ascontiguousarray(rec[n]).astype(rec[n].dtype.newbyteorder('='))
                   for n in names}
        return Hdu(columns=columns, header=cards)
    data = None
    if nbytes:
        dtype = np.dtype(_BITPIX2DTYPE[int(cards['BITPIX'])])
        data = np.frombuffer(raw, dtype=dtype).reshape(shape)
        data = data.astype(dtype.newbyteorder('='))
    return Hdu(data=data, header=cards)


def _read_all(filename):
    hdus = []
    size = os.path.getsize(filename)
    with open(filename, 'rb') as fh:
        while fh.tell() < size:
            hdus.append(_read_hdu(fh))
    return hdus


def read(filename, ext=0):
    """Data of HDU ``ext``: ndarray for images, {name: array} for tables.
    ``ext=0`` with an empty primary falls through to the first extension
    carrying data (fitsio compatibility)."""
    hdus = _read_all(filename)
    if ext == 0 and hdus[0].data is None and hdus[0].columns is None and len(hdus) > 1:
        ext = 1
    hdu = hdus[ext]
    return hdu.columns if hdu.columns is not None else hdu.data


def read_header(filename, ext=0):
    return _read_all(filename)[ext].header


def hdus(filename):
    """All HDUs (fitsio.FITS-style iteration: ``for hdu in hdus(fn)[1:]``)."""
    return _read_all(filename)


def _card(key, value, comment=''):
    if isinstance(value, bool):
        val = 'T' if value else 'F'
        body = '{:>20}'.format(val)
    elif isinstance(value, (int, np.integer)):
        body = '{:>20d}'.format(int(value))
    elif isinstance(value, (float, np.floating)):
        body = '{:>20s}'.format(repr(float(value)).upper())
    else:
        text = str(value).replace("'", "''")
        body = "'{:<8s}'".format(text)
    card = '{:<8s}= {}'.format(key[:8], body)
    if comment:
        card += ' / ' + comment
    return '{:<80s}'.format(card[:CARD])


def _write_header(fh, cards):
    text = ''.join(_card(k, v) for k, v in cards) + '{:<80s}'.format('END')
    pad = (-len(text)) % BLOCK
    fh.write((text + ' ' * pad).encode('ascii'))


def _write_data(fh, raw):
    fh.write(raw)
    fh.write(b'\0' * ((-len(raw)) % BLOCK))


def write(filename, hdus):
    """Write HDUs; the first is the primary (its table, if any, is demoted
    to the second HDU after an empty primary, as FITS requires)."""
    hdus = list(hdus)
    if not hdus or hdus[0].columns is not None:
        hdus = [Hdu()] + hdus
    with open(filename, 'wb') as fh:
        for i, hdu in enumerate(hdus):
            primary = i == 0
            extra = [(k, v) for k, v in hdu.header.items()
                     if k not in ('SIMPLE', 'XTENSION', 'BITPIX', 'NAXIS', 'END',
                                  'PCOUNT', 'GCOUNT', 'TFIELDS')
                     and not k.startswith(('NAXIS', 'TTYPE', 'TFORM'))]
            if hdu.columns is not None:
                names = list(hdu.columns)
                arrays = [np.ascontiguousarray(hdu.columns[n]) for n in names]
                nrows = len(arrays[0]) if arrays else 0
                formats = []
                for n, a in zip(names, arrays):
                    if a.ndim != 1 or len(a) != nrows:
                        raise ValueError('column {!r} must be 1-D of common length'.format(n))
                    key = a.dtype.newbyteorder('=').str.lstrip('<>=|')
                    if key not in _DTYPE2TFORM:
                        raise NotImplementedError('unsupported column dtype {!r}'.format(a.dtype))
                    formats.append(_DTYPE2TFORM[key])
                rowbytes = sum(a.dtype.itemsize for a in arrays)
                cards = [('XTENSION', 'BINTABLE'), ('BITPIX', 8), ('NAXIS', 2),
                         ('NAXIS1', rowbytes), ('NAXIS2', nrows),
                         ('PCOUNT', 0), ('GCOUNT', 1), ('TFIELDS', len(names))]
                for j, (n, f) in enumerate(zip(names, formats), start=1):
                    cards += [('TTYPE{:d}'.format(j), n), ('TFORM{:d}'.format(j), '1' + f)]
                _write_header(fh, cards + extra)
                rec = np.empty(nrows, dtype=np.dtype({
                    'names': names,
                    'formats': [_TFORM2DTYPE[f] for f in formats]}))
                for n, a in zip(names, arrays):
                    rec[n] = a
                _write_data(fh, rec.tobytes())
            else:
                data = hdu.data
                if data is None:
                    cards = ([('SIMPLE', True)] if primary else [('XTENSION', 'IMAGE')])
                    cards += [('BITPIX', 8), ('NAXIS', 0)]
                    if not primary:
                        cards += [('PCOUNT', 0), ('GCOUNT', 1)]
                    _write_header(fh, cards + extra)
                    continue
                key = data.dtype.newbyteorder('=').str.lstrip('<>=|')
                bitpix = {'u1': 8, 'i2': 16, 'i4': 32, 'i8': 64,
                          'f4': -32, 'f8': -64}.get(key)
                if bitpix is None:
                    data = data.astype('f8')
                    bitpix = -64
                cards = ([('SIMPLE', True)] if primary else [('XTENSION', 'IMAGE')])
                cards += [('BITPIX', bitpix), ('NAXIS', data.ndim)]
                cards += [('NAXIS{:d}'.format(j), n)
                          for j, n in enumerate(data.shape[::-1], start=1)]
                if not primary:
                    cards += [('PCOUNT', 0), ('GCOUNT', 1)]
                _write_header(fh, cards + extra)
                big = data.astype(data.dtype.newbyteorder('>'))
                _write_data(fh, np.ascontiguousarray(big).tobytes())
