"""Reference provenance digests (GA4GH refget sequence-collection spec).

Equivalent of the reference's `seqcol_rs` usage
(`digest_utils.rs:179-202`, `:11-25`): Level1 seqcol digests over names,
lengths, and (when sequences are available) sequence content, recorded into
`meta_info.json` for provenance.
"""

from __future__ import annotations

import base64
import hashlib
import json
import re
import threading
from typing import Dict, List, Optional, Sequence


def sha512t24u(data: bytes) -> str:
    """GA4GH truncated sha512 digest: base64url(sha512(data)[:24])."""
    return base64.urlsafe_b64encode(hashlib.sha512(data).digest()[:24]).decode(
        "ascii"
    )


def _canon(obj) -> bytes:
    """RFC 8785-style canonical JSON for the simple types used here."""
    return json.dumps(
        obj, separators=(",", ":"), sort_keys=True, ensure_ascii=False
    ).encode()


def refget_sequence_digest(seq: str) -> str:
    """ga4gh SQ digest of one uppercase sequence."""
    return "SQ." + sha512t24u(seq.upper().encode())


# canonical JSON passes these through verbatim under ensure_ascii=False;
# anything else (quote, backslash, control chars) needs real escaping
_JSON_PLAIN = re.compile(r'^[^"\\\x00-\x1f]*$')


def seqcol_level1(
    names: Sequence[str],
    lengths: Sequence[int],
    sequences: Optional[Sequence[str]] = None,
) -> Dict[str, str]:
    """Level1 seqcol digests: one digest per attribute."""
    out = {
        "lengths": sha512t24u(_canon([int(x) for x in lengths])),
        "names": sha512t24u(_canon(list(names))),
    }
    # sorted_name_length_pairs: digest each canonical {"length","name"}
    # object, sort the digests, digest the array of them. The canonical
    # bytes are assembled directly for escape-free names (the common
    # case; large headers make the json.dumps round trip the hot spot)
    # — `tests/test_digest.py` pins equality with the json.dumps form.
    _sha512, _b64 = hashlib.sha512, base64.urlsafe_b64encode
    _plain = _JSON_PLAIN.match
    pair_digests = sorted(
        _b64(
            _sha512(
                b'{"length":%d,"name":"%s"}' % (int(l), n.encode())
                if _plain(n)
                else _canon({"length": int(l), "name": n})
            ).digest()[:24]
        ).decode("ascii")
        for n, l in zip(names, lengths)
    )
    out["sorted_name_length_pairs"] = sha512t24u(_canon(pair_digests))
    if sequences is not None:
        seq_digests = [refget_sequence_digest(s) for s in sequences]
        out["sequences"] = sha512t24u(_canon(seq_digests))
    return out


def digest_result_json(
    names: Sequence[str],
    lengths: Sequence[int],
    sequences: Optional[Sequence[str]] = None,
) -> dict:
    """Shape of a `DigestResult::to_json` for meta_info.json."""
    result = {"seqcol_digest": seqcol_level1(names, lengths, sequences)}
    if sequences is not None:
        h_names = hashlib.sha256()
        for n in names:
            h_names.update(n.encode())
        h_seqs = hashlib.sha256()
        for s in sequences:
            h_seqs.update(s.upper().encode())
        result["sha256_digests"] = {
            "sha256_names": h_names.hexdigest(),
            "sha256_seqs": h_seqs.hexdigest(),
        }
    return result


def digest_from_header(names: Sequence[str], lengths: Sequence[int]) -> dict:
    """Digest computed from a BAM header (names + lengths only),
    mirroring `digest_from_header` (`digest_utils.rs:179-202`)."""
    return digest_result_json(names, lengths)


class LazyDigest:
    """A digest computed on a background thread (the reference computes
    digests on spawned threads too, `digest_utils.rs:11-25`), so large
    headers don't serialize against route build / EM. `resolve()` joins
    and returns the dict; `get_json_info` resolves these transparently."""

    def __init__(self, fn, *fn_args):
        self._value = None
        self._err = None

        def run():
            try:
                self._value = fn(*fn_args)
            except BaseException as e:  # noqa: BLE001 — re-raised at join
                self._err = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def resolve(self) -> dict:
        self._thread.join()
        if self._err is not None:
            raise self._err
        return self._value


def resolve_lazy_digests(digest: dict) -> dict:
    """Resolve any LazyDigest values in a digest map (in place)."""
    for k, v in digest.items():
        if isinstance(v, LazyDigest):
            digest[k] = v.resolve()
    return digest


# ---------------------------------------------------------------------------
# Index digest footer `[json][len:u64][ver:u8]["OARFISHSIG"]`
# (`digest_utils.rs:34-62,113-177`) — format-compatible so an index written
# by either engine carries the same provenance footer.
# ---------------------------------------------------------------------------

DIGEST_VERSION = 4
FOOTER_MAGIC = b"OARFISHSIG"


def append_digest_footer(idx_file: str, digest_map: dict) -> None:
    payload = json.dumps(digest_map, separators=(",", ":")).encode()
    with open(idx_file, "ab") as fh:
        fh.write(payload)
        fh.write(len(payload).to_bytes(8, "little"))
        fh.write(bytes([DIGEST_VERSION]))
        fh.write(FOOTER_MAGIC)


def read_digest_footer(idx_file: str) -> dict:
    with open(idx_file, "rb") as fh:
        fh.seek(0, 2)
        size = fh.tell()
        tail = len(FOOTER_MAGIC) + 1 + 8
        if size < tail:
            raise ValueError("file too small to hold an oarfish footer")
        fh.seek(size - len(FOOTER_MAGIC))
        if fh.read(len(FOOTER_MAGIC)) != FOOTER_MAGIC:
            raise ValueError("no OARFISHSIG footer present")
        fh.seek(size - len(FOOTER_MAGIC) - 1)
        version = fh.read(1)[0]
        if version != DIGEST_VERSION:
            raise ValueError(f"unsupported digest footer version {version}")
        fh.seek(size - tail)
        (json_len,) = (int.from_bytes(fh.read(8), "little"),)
        fh.seek(size - tail - json_len)
        return json.loads(fh.read(json_len))
