"""Minimal MS-NRBF (.NET BinaryFormatter remoting format) reader.

Just enough of [MS-NRBF] to walk a Paint.NET .pdn object graph: class
records with member type info, strings, primitive arrays, references, and
nulls.  Produces a graph of `NrbfObject`/`NrbfArray` nodes plus the byte
offset where the stream's MessageEnd record finished (Paint.NET appends its
DeferredFormatter payload there — see io/pdn.py).

The reference reads this format out of process with a C# host
(src/pdn.rs:40-160); this is the native equivalent.  Host code: the port's
own copy of paintfe_tpu.io.nrbf.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Optional

# PrimitiveTypeEnum -> (struct fmt, size)
_PRIM = {
    1: ("<?", 1),   # Boolean
    2: ("<B", 1),   # Byte
    3: None,         # Char (utf8, handled specially)
    6: ("<d", 8),   # Double
    7: ("<h", 2),   # Int16
    8: ("<i", 4),   # Int32
    9: ("<q", 8),   # Int64
    10: ("<b", 1),  # SByte
    11: ("<f", 4),  # Single
    12: ("<q", 8),  # TimeSpan (ticks)
    13: ("<Q", 8),  # DateTime (raw)
    14: ("<H", 2),  # UInt16
    15: ("<I", 4),  # UInt32
    16: ("<Q", 8),  # UInt64
}


class NrbfError(ValueError):
    pass


@dataclasses.dataclass
class NrbfObject:
    object_id: int
    class_name: str
    members: Dict[str, Any]

    def get(self, name, default=None):
        return self.members.get(name, default)


@dataclasses.dataclass
class NrbfArray:
    object_id: int
    items: List[Any]


@dataclasses.dataclass
class _Ref:
    id: int


@dataclasses.dataclass
class _ClassDesc:
    name: str
    member_names: List[str]
    bin_types: Optional[List[int]]
    extra: Optional[List[Any]]


class NrbfReader:
    def __init__(self, data: bytes, offset: int = 0):
        self.data = data
        self.pos = offset
        self.objects: Dict[int, Any] = {}
        self.classes: Dict[int, _ClassDesc] = {}
        self.end_pos: Optional[int] = None
        self.root_id: Optional[int] = None

    # -- primitives -----------------------------------------------------------

    def _take(self, n):
        b = self.data[self.pos:self.pos + n]
        if len(b) != n:
            raise NrbfError("truncated NRBF stream")
        self.pos += n
        return b

    def _u8(self):
        return self._take(1)[0]

    def _i32(self):
        return struct.unpack("<i", self._take(4))[0]

    def _lpstring(self):
        # 7-bit encoded length prefix
        length = 0
        shift = 0
        while True:
            b = self._u8()
            length |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return self._take(length).decode("utf-8")

    def _primitive(self, type_enum):
        if type_enum == 3:  # Char: one utf8 code point
            first = self._u8()
            extra = 0
            if first >= 0xF0:
                extra = 3
            elif first >= 0xE0:
                extra = 2
            elif first >= 0xC0:
                extra = 1
            return (bytes([first]) + self._take(extra)).decode("utf-8")
        if type_enum == 5:  # Decimal: LPString
            return self._lpstring()
        fmt = _PRIM.get(type_enum)
        if fmt is None:
            raise NrbfError(f"unsupported primitive type {type_enum}")
        return struct.unpack(fmt[0], self._take(fmt[1]))[0]

    # -- class records ----------------------------------------------------------

    def _class_info(self):
        object_id = self._i32()
        name = self._lpstring()
        count = self._i32()
        members = [self._lpstring() for _ in range(count)]
        return object_id, name, members

    def _member_type_info(self, count):
        bin_types = [self._u8() for _ in range(count)]
        extra = []
        for bt in bin_types:
            if bt == 0 or bt == 7:      # Primitive / PrimitiveArray
                extra.append(self._u8())
            elif bt == 3:               # SystemClass
                extra.append(self._lpstring())
            elif bt == 4:               # Class
                extra.append((self._lpstring(), self._i32()))
            else:
                extra.append(None)
        return bin_types, extra

    def _read_members(self, object_id, desc: _ClassDesc):
        obj = NrbfObject(object_id, desc.name, {})
        self.objects[object_id] = obj
        pending_nulls = 0
        for idx, mname in enumerate(desc.member_names):
            if pending_nulls:
                obj.members[mname] = None
                pending_nulls -= 1
                continue
            bt = desc.bin_types[idx] if desc.bin_types else 2
            if bt == 0:
                obj.members[mname] = self._primitive(desc.extra[idx])
            else:
                value, nulls = self._read_value()
                obj.members[mname] = value
                pending_nulls = nulls
        return obj

    # -- record dispatch ---------------------------------------------------------

    def _read_value(self):
        """Read a referenceable record used in a member/array slot.
        Returns (value, extra_null_count)."""
        while True:
            rec = self._u8()
            if rec == 12:
                # MS-NRBF memberReference = BinaryLibrary? + value: the
                # formatter emits a library record before the first class
                # of each new assembly, which can land mid-member; consume
                # it and read the FOLLOWING record as the slot's value
                # (treating the library itself as the value desynced the
                # stream for multi-assembly graphs).
                self._read_record(rec)
                continue
            break
        if rec == 10:  # ObjectNull
            return None, 0
        if rec == 13:  # ObjectNullMultiple256
            n = self._u8()
            if n <= 0:  # 0 would leave pending=-1 (truthy) and desync
                raise NrbfError("ObjectNullMultiple256 with count <= 0")
            return None, n - 1
        if rec == 14:  # ObjectNullMultiple
            n = self._i32()
            if n <= 0:
                raise NrbfError("ObjectNullMultiple with count <= 0")
            return None, n - 1
        if rec == 9:   # MemberReference
            return _Ref(self._i32()), 0
        if rec == 8:   # MemberPrimitiveTyped
            te = self._u8()
            return self._primitive(te), 0
        return self._read_record(rec), 0

    def _read_record(self, rec):
        if rec == 0:  # SerializationHeader
            self.root_id = self._i32()
            self._i32()
            self._i32()
            self._i32()
            return None
        if rec == 12:  # BinaryLibrary
            self._i32()
            self._lpstring()
            return None
        if rec == 6:   # BinaryObjectString
            object_id = self._i32()
            s = self._lpstring()
            self.objects[object_id] = s
            return s
        if rec == 1:   # ClassWithId
            object_id = self._i32()
            meta_id = self._i32()
            desc = self.classes.get(meta_id)
            if desc is None:
                raise NrbfError(f"ClassWithId references unknown class {meta_id}")
            return self._read_members(object_id, desc)
        if rec in (2, 3, 4, 5):
            object_id, name, members = self._class_info()
            if rec in (4, 5):
                bin_types, extra = self._member_type_info(len(members))
            else:
                bin_types, extra = None, None
            if rec in (3, 5):
                self._i32()  # library id
            desc = _ClassDesc(name, members, bin_types, extra)
            self.classes[object_id] = desc
            return self._read_members(object_id, desc)
        if rec == 15:  # ArraySinglePrimitive
            object_id = self._i32()
            length = self._i32()
            te = self._u8()
            if te in _PRIM and te not in (3, 5):
                fmt, size = _PRIM[te]
                raw = self._take(length * size)
                vals = list(struct.unpack("<%d%s" % (length, fmt[1]), raw))
            else:
                vals = [self._primitive(te) for _ in range(length)]
            arr = NrbfArray(object_id, vals)
            self.objects[object_id] = arr
            return arr
        if rec in (16, 17):  # ArraySingleObject / ArraySingleString
            object_id = self._i32()
            length = self._i32()
            arr = NrbfArray(object_id, [])
            self.objects[object_id] = arr
            pending = 0
            while len(arr.items) < length:
                if pending:
                    arr.items.append(None)
                    pending -= 1
                    continue
                value, pending = self._read_value()
                arr.items.append(value)
            return arr
        if rec == 7:  # BinaryArray
            object_id = self._i32()
            array_type = self._u8()
            rank = self._i32()
            lengths = [self._i32() for _ in range(rank)]
            if array_type in (3, 4, 5):  # offset variants
                for _ in range(rank):
                    self._i32()
            te = self._u8()
            if te == 0 or te == 7:
                extra = self._u8()
            elif te == 3:
                extra = self._lpstring()
            elif te == 4:
                self._lpstring()
                self._i32()
                extra = None
            else:
                extra = None
            total = 1
            for ln in lengths:
                total *= ln
            arr = NrbfArray(object_id, [])
            self.objects[object_id] = arr
            pending = 0
            while len(arr.items) < total:
                if pending:
                    arr.items.append(None)
                    pending -= 1
                    continue
                if te == 0:
                    arr.items.append(self._primitive(extra))
                else:
                    value, pending = self._read_value()
                    arr.items.append(value)
            return arr
        raise NrbfError(f"unsupported NRBF record {rec} at {self.pos - 1}")

    # -- top level ---------------------------------------------------------------

    def parse(self):
        """Read records until MessageEnd; resolve references in place."""
        while True:
            rec = self._u8()
            if rec == 11:  # MessageEnd
                self.end_pos = self.pos
                break
            self._read_record(rec)
        self._resolve()
        return self

    def _resolve(self):
        def fix(v):
            return self.objects.get(v.id) if isinstance(v, _Ref) else v

        for obj in list(self.objects.values()):
            if isinstance(obj, NrbfObject):
                for k in obj.members:
                    obj.members[k] = fix(obj.members[k])
            elif isinstance(obj, NrbfArray):
                obj.items = [fix(x) for x in obj.items]

    def find_instances(self, name_substring: str) -> List[NrbfObject]:
        """All class instances whose type name contains the substring, in
        stream (serialization) order."""
        return [
            o for o in self.objects.values()
            if isinstance(o, NrbfObject) and name_substring in o.class_name
        ]
