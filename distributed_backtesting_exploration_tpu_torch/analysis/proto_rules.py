"""dbxlint wire-layer rule: ``.proto`` source vs generated ``_pb2`` drift.

The reference's ``analysis/proto_rules.py``, over the port's
``rpc/backtesting.proto`` and ``rpc/backtesting_pb2.py``. A
``backtesting_pb2.py`` may be regenerated WITHOUT protoc, by editing the
serialized FileDescriptorProto by hand (the reference's
``StatsReply.obs_json`` was added so). Nothing but review kept the two in
sync; a drifted pb2 silently reads/writes the wrong field
numbers on the wire. This rule parses the ``.proto`` text with a small
tokenizer and structurally compares messages (field name -> number),
enums, and service methods against the imported pb2 module's descriptor.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import re

from .core import Finding, LintContext, PACKAGE_NAME


# ---------------------------------------------------------------------------
# Proto text parsing (proto3 subset: messages w/ scalar+map fields, nested
# messages, enums, services — exactly what this repo's contract uses)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProtoModel:
    """Structural view of one .proto file (or one pb2 descriptor)."""

    messages: dict       # name -> {field_name: number}
    enums: dict          # name -> {value_name: number}
    services: dict       # name -> {method: (input_type, output_type)}
    lines: dict = dataclasses.field(default_factory=dict)
    # lines: (kind, container, item) -> 1-indexed source line (text side
    # only; used to anchor findings).


# Content patterns are unanchored and finditer'd so one-line blocks
# (`message Ping { int32 n = 1; }`) and several `;`-separated declarations
# on one line all parse.
_FIELD_RE = re.compile(
    r"(?:\b(?:optional|repeated|required)\s+)?"
    r"(?:map\s*<[^>]+>|[A-Za-z0-9_.]+)\s+"
    r"([A-Za-z0-9_]+)\s*=\s*(\d+)\s*(?:\[[^\]]*\])?\s*;")
_ENUM_VALUE_RE = re.compile(r"([A-Za-z0-9_]+)\s*=\s*(\d+)\s*;")
# The optional `stream` keywords are CAPTURED, not skipped: a pb2 whose
# method drops (or invents) server streaming is a wire-breaking drift —
# the client would issue a unary call against a streaming handler. The
# model encodes streaming-ness as a "stream " prefix on the type name,
# so unary signatures stay plain (input, output) tuples.
_RPC_RE = re.compile(
    r"\brpc\s+([A-Za-z0-9_]+)\s*\(\s*(stream\s+)?([A-Za-z0-9_.]+)\s*\)\s*"
    r"returns\s*\(\s*(stream\s+)?([A-Za-z0-9_.]+)\s*\)")
_BLOCK_RE = re.compile(r"^\s*(message|enum|service)\s+([A-Za-z0-9_]+)\s*\{")


def _strip_comments(text: str) -> str:
    """Remove // and /* */ comments, preserving line structure."""
    text = re.sub(r"/\*.*?\*/",
                  lambda m: "\n" * m.group(0).count("\n"),
                  text, flags=re.S)
    return "\n".join(line.split("//")[0] for line in text.splitlines())


def parse_proto_text(text: str) -> ProtoModel:
    """Parse a proto3 file into a :class:`ProtoModel` (line-numbered).

    Unrecognized braced blocks (``oneof``, ``extensions``, option
    aggregates) push anonymous frames so their closing brace pops only
    themselves — fields inside a ``oneof`` attribute to the enclosing
    message, exactly like the descriptor flattens them, and fields AFTER
    the block stay attributed correctly."""
    model = ProtoModel({}, {}, {})
    stack: list[tuple[str, str | None]] = []   # (kind, name) of open blocks

    def adjust(segment: str) -> None:
        for _ in range(segment.count("{")):
            stack.append(("anon", None))
        for _ in range(min(segment.count("}"), len(stack))):
            stack.pop()

    def consume(content: str, lineno: int) -> None:
        """Match field/enum/rpc declarations in ``content``, attributed to
        the innermost NAMED frame (a oneof's fields belong to its
        enclosing message in the descriptor)."""
        kind, name = next(
            ((k, n) for k, n in reversed(stack) if k != "anon"),
            (None, None))
        if kind == "service":
            for m in _RPC_RE.finditer(content):
                meth, in_stream, inp, out_stream, outp = m.groups()
                model.services[name][meth] = (
                    ("stream " if in_stream else "") + inp.split(".")[-1],
                    ("stream " if out_stream else "") + outp.split(".")[-1])
                model.lines[("rpc", name, meth)] = lineno
        elif kind == "enum":
            for m in _ENUM_VALUE_RE.finditer(content):
                model.enums[name][m.group(1)] = int(m.group(2))
                model.lines[("enumval", name, m.group(1))] = lineno
        elif kind == "message":
            for m in _FIELD_RE.finditer(content):
                model.messages[name][m.group(1)] = int(m.group(2))
                model.lines[("field", name, m.group(1))] = lineno

    for lineno, line in enumerate(_strip_comments(text).splitlines(), 1):
        m = _BLOCK_RE.match(line)
        if m:
            kind, name = m.group(1), m.group(2)
            if kind == "message":
                # Nested messages key by their simple name — the pb2
                # descriptor side is flattened the same way.
                model.messages.setdefault(name, {})
            elif kind == "enum":
                model.enums.setdefault(name, {})
            elif kind == "service":
                model.services.setdefault(name, {})
            model.lines[(kind, name, None)] = lineno
            stack.append((kind, name))
            tail = line.split("{", 1)[1]
            consume(tail, lineno)       # one-liner blocks keep their fields
            adjust(tail)
            continue
        if stack:
            consume(line, lineno)
        adjust(line)
    return model


def describe_pb2(pb2_module) -> ProtoModel:
    """ProtoModel of a generated pb2 module's file descriptor."""
    fd = pb2_module.DESCRIPTOR
    messages: dict = {}

    def add_message(desc):
        messages[desc.name] = {f.name: f.number for f in desc.fields}
        for nested in desc.nested_types:
            if nested.GetOptions().map_entry:
                continue   # synthesized map-entry types have no proto text
            add_message(nested)

    for desc in fd.message_types_by_name.values():
        add_message(desc)
    enums = {e.name: {v.name: v.number for v in e.values}
             for e in fd.enum_types_by_name.values()}
    # Streaming flags live on the serialized FileDescriptorProto, not the
    # runtime MethodDescriptor surface (portable across protobuf
    # generations) — re-parse it for the same "stream " prefix encoding
    # the text side uses.
    from google.protobuf import descriptor_pb2

    fdp = descriptor_pb2.FileDescriptorProto.FromString(fd.serialized_pb)
    streaming = {
        (s.name, m.name): (m.client_streaming, m.server_streaming)
        for s in fdp.service for m in s.method}
    services = {}
    for s in fd.services_by_name.values():
        sigs = {}
        for m in s.methods:
            c_stream, s_stream = streaming.get((s.name, m.name),
                                               (False, False))
            sigs[m.name] = (
                ("stream " if c_stream else "") + m.input_type.name,
                ("stream " if s_stream else "") + m.output_type.name)
        services[s.name] = sigs
    return ProtoModel(messages, enums, services)


def diff_models(proto: ProtoModel, pb2: ProtoModel, *, path: str,
                rule: str = "proto-drift") -> list[Finding]:
    """Structural diff, proto text as the source of truth."""
    out: list[Finding] = []

    def line(kind, container, item=None) -> int:
        return proto.lines.get((kind, container, item),
                               proto.lines.get((kind, container, None), 1))

    for name, fields in proto.messages.items():
        got = pb2.messages.get(name)
        if got is None:
            out.append(Finding(rule, path, line("message", name),
                               f"message `{name}` missing from the "
                               "generated pb2 descriptor"))
            continue
        for fname, num in fields.items():
            if fname not in got:
                out.append(Finding(
                    rule, path, line("field", name, fname),
                    f"field `{name}.{fname}` missing from the pb2 "
                    "descriptor"))
            elif got[fname] != num:
                out.append(Finding(
                    rule, path, line("field", name, fname),
                    f"field `{name}.{fname}` is number {num} in the "
                    f".proto but {got[fname]} in the pb2 descriptor — "
                    "wire-incompatible drift"))
        for fname in sorted(set(got) - set(fields)):
            out.append(Finding(
                rule, path, line("message", name),
                f"pb2 descriptor has field `{name}.{fname}` "
                f"(number {got[fname]}) that the .proto does not declare"))
    for name in sorted(set(pb2.messages) - set(proto.messages)):
        out.append(Finding(rule, path, 1,
                           f"pb2 descriptor has message `{name}` that the "
                           ".proto does not declare"))

    for name, values in proto.enums.items():
        got = pb2.enums.get(name)
        if got is None:
            out.append(Finding(rule, path, line("enum", name),
                               f"enum `{name}` missing from the pb2 "
                               "descriptor"))
            continue
        if got != values:
            out.append(Finding(
                rule, path, line("enum", name),
                f"enum `{name}` values differ: .proto {values} vs "
                f"pb2 {got}"))

    for name, methods in proto.services.items():
        got = pb2.services.get(name, None)
        if got is None:
            # Message-only codegen (this repo's case: the service layer is
            # hand-written in service.py) — nothing to compare.
            continue
        for meth, sig in methods.items():
            if meth not in got:
                out.append(Finding(
                    rule, path, line("rpc", name, meth),
                    f"rpc `{name}.{meth}` missing from the pb2 "
                    "descriptor"))
            elif got[meth] != sig:
                out.append(Finding(
                    rule, path, line("rpc", name, meth),
                    f"rpc `{name}.{meth}` signature differs: .proto "
                    f"{sig} vs pb2 {got[meth]}"))
        for meth in sorted(set(got) - set(methods)):
            out.append(Finding(
                rule, path, line("service", name),
                f"pb2 descriptor has rpc `{name}.{meth}` that the "
                ".proto does not declare"))
    return out


class ProtoDriftRule:
    """Compare every ``.proto`` under the root against its ``_pb2`` module."""

    name = "proto-drift"
    doc = ".proto source vs generated _pb2 descriptor divergence"

    def applicable(self, ctx: LintContext) -> bool:
        # Single-file lint targets have no proto scan: report the rule as
        # skipped, never as clean coverage.
        return os.path.isdir(ctx.root)

    def check(self, ctx: LintContext) -> list[Finding]:
        out: list[Finding] = []
        if not self.applicable(ctx):
            return out
        base = ctx.root
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fname in sorted(filenames):
                if not fname.endswith(".proto"):
                    continue
                proto_path = os.path.join(dirpath, fname)
                stem = fname[:-len(".proto")]
                pb2_path = os.path.join(dirpath, f"{stem}_pb2.py")
                rel = os.path.relpath(proto_path, base)
                if not os.path.exists(pb2_path):
                    out.append(Finding(
                        self.name, rel, 1,
                        f"`{fname}` has no sibling `{stem}_pb2.py` — the "
                        "wire contract is declared but not generated"))
                    continue
                pb2_module = self._import_pb2(ctx, pb2_path, base)
                if pb2_module is None:
                    out.append(Finding(
                        self.name, rel, 1,
                        f"could not import `{stem}_pb2.py` for structural "
                        "comparison"))
                    continue
                with open(proto_path, encoding="utf-8") as fh:
                    model = parse_proto_text(fh.read())
                out.extend(diff_models(model, describe_pb2(pb2_module),
                                       path=rel, rule=self.name))
        return out

    @staticmethod
    def _import_pb2(ctx: LintContext, pb2_path: str, base: str):
        """Import the pb2 via its dotted package name (a second standalone
        load would re-register descriptors in the default pool and fail)."""
        rel = os.path.relpath(pb2_path, base)
        parts = rel[:-len(".py")].split(os.sep)
        if ctx.package:
            dotted = ".".join([PACKAGE_NAME] + parts)
        else:
            dotted = ".".join(parts)
        try:
            return importlib.import_module(dotted)
        except Exception:
            return None
