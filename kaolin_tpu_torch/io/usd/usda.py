"""Minimal self-contained USDA (ASCII USD) document model.

Port of ``kaolin_tpu/io/usd/usda.py`` (numpy only, no ``pxr``): a small
reader and writer for the USDA subset that the kaolin workflows produce
(Mesh / Points / PointInstancer / Material prims with time-sampled
attributes).  The writer is the JAX package's: values are formatted by the
same ``_fmt_value``, so both packages write the same bytes for the same
values.  The reader gives the JAX reader's values and dtypes, but reads a
``[...]`` array of numbers in one step instead of token by token, which
is what a large mesh's text spends its time on.
"""

import re
from typing import Any, Dict, List

import numpy as np

__all__ = ['UsdaPrim', 'UsdaStage', 'parse_usda', 'TimeSampled']


class TimeSampled(dict):
    """Attribute value holder for `attr.timeSamples = { t: v, ... }`."""


class UsdaPrim:
    def __init__(self, name, type_name='', parent=None):
        self.name = name
        self.type_name = type_name
        self.parent = parent
        self.attrs: Dict[str, Any] = {}
        self.metadata: Dict[str, Any] = {}
        self.children: List['UsdaPrim'] = []

    @property
    def path(self):
        if self.parent is None or self.parent.name == '/':
            return f'/{self.name}'
        return f'{self.parent.path}/{self.name}'

    def child(self, name):
        for c in self.children:
            if c.name == name:
                return c
        return None

    def define_child(self, name, type_name=''):
        c = self.child(name)
        if c is None:
            c = UsdaPrim(name, type_name, self)
            self.children.append(c)
        elif type_name and not c.type_name:
            c.type_name = type_name
        return c

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


class UsdaStage:
    def __init__(self):
        self.root = UsdaPrim('/', '')
        self.metadata: Dict[str, Any] = {'metersPerUnit': 1,
                                         'upAxis': 'Y'}

    def get_prim(self, path):
        node = self.root
        for part in path.strip('/').split('/'):
            if not part:
                continue
            node = node.child(part)
            if node is None:
                return None
        return node

    def define_prim(self, path, type_name=''):
        node = self.root
        parts = path.strip('/').split('/')
        for i, part in enumerate(parts):
            t = type_name if i == len(parts) - 1 else 'Xform'
            node = node.define_child(part, t)
        return node

    def prims(self):
        for c in self.root.children:
            yield from c.walk()

    # -- serialization -----------------------------------------------------
    def dumps(self):
        lines = ['#usda 1.0', '(']
        for k, v in self.metadata.items():
            lines.append(f'    {_fmt_meta(k, v)}')
        lines.append(')')
        lines.append('')
        for child in self.root.children:
            lines.extend(_dump_prim(child, 0))
        return '\n'.join(lines) + '\n'

    def save(self, path):
        with open(path, 'w') as f:
            f.write(self.dumps())

    @classmethod
    def load(cls, path):
        with open(path, 'r') as f:
            return parse_usda(f.read())


def _fmt_meta(k, v):
    if isinstance(v, str):
        return f'{k} = "{v}"'
    return f'{k} = {v}'


def _fmt_value(v):
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, bool):
        return 'true' if v else 'false'
    if isinstance(v, (int, float)):
        return repr(v)
    arr = np.asarray(v)
    if arr.ndim == 0:
        return repr(arr.item())
    if arr.ndim == 1:
        return '[' + ', '.join(repr(x.item()) if hasattr(x, 'item')
                               else repr(x) for x in arr) + ']'
    if arr.ndim == 2:
        rows = ', '.join(
            '(' + ', '.join(repr(float(x)) if arr.dtype.kind == 'f'
                            else repr(int(x)) for x in row) + ')'
            for row in arr)
        return '[' + rows + ']'
    raise ValueError(f'cannot serialize array of ndim {arr.ndim}')


def _usd_type(name, v):
    """Choose a USD attribute type declaration."""
    if isinstance(v, str):
        return 'string'
    if isinstance(v, bool):
        return 'bool'
    if isinstance(v, int):
        return 'int'
    if isinstance(v, float):
        return 'float'
    arr = np.asarray(v)
    if name == 'points':
        return 'point3f[]'
    if name in ('normals',):
        return 'normal3f[]'
    if arr.ndim <= 1:
        return ('int[]' if arr.dtype.kind in 'iu' else 'float[]')
    if arr.ndim == 2 and arr.shape[1] == 3:
        return ('int3[]' if arr.dtype.kind in 'iu' else 'float3[]')
    if arr.ndim == 2 and arr.shape[1] == 2:
        return 'float2[]'
    return 'float[]'


def _dump_prim(prim, depth):
    pad = '    ' * depth
    head = f'{pad}def {prim.type_name} "{prim.name}"'.rstrip()
    lines = [head, f'{pad}{{']
    inner = '    ' * (depth + 1)
    for name, val in prim.attrs.items():
        if isinstance(val, TimeSampled):
            sample0 = next(iter(val.values()))
            t = _usd_type(name, sample0)
            lines.append(f'{inner}{t} {name}.timeSamples = {{')
            for time_code in sorted(val.keys()):
                lines.append(
                    f'{inner}    {_fmt_time(time_code)}: '
                    f'{_fmt_value(val[time_code])},')
            lines.append(f'{inner}}}')
        else:
            t = _usd_type(name, val)
            lines.append(f'{inner}{t} {name} = {_fmt_value(val)}')
    for c in prim.children:
        lines.extend(_dump_prim(c, depth + 1))
    lines.append(f'{pad}}}')
    return lines


def _fmt_time(t):
    return repr(int(t)) if float(t).is_integer() else repr(float(t))


# -- parsing ---------------------------------------------------------------

_TOKEN_RE = re.compile(r'''
    "(?:[^"\\]|\\.)*"          # string
  | \#[^\n]*                   # comment
  | [{}()\[\]=:,]              # punctuation
  | [^\s{}()\[\]=:,"]+         # atom
''', re.VERBOSE)


# a numeric array's body: what the writer emits for int and float arrays
_NUMERIC_BODY_RE = re.compile(r'[\s0-9eE.+\-,()]*')
_ROW_RE = re.compile(r'\(([^()]*)\)')
_SEPARATORS_RE = re.compile(r'[\s,]*')
# more digits than int64 holds: the token-by-token parse makes an object
# array of such integers
_LONG_INT_RE = re.compile(r'\d{19}')
_INT_ITEM_RE = re.compile(r'[+-]?\d+')
# an item that is an integer, in a body that also holds floats
_INT_AMONG_RE = re.compile(r'(?:^|[,(])\s*[+-]?\d+\s*(?=[,)]|$)')


def _numbers(items, kind):
    """The numbers of the strings ``items`` as the token-by-token parse
    reads them: ``kind`` 'int' (int64), 'float' (float64) or 'mixed'
    (float64, the integers read as ints first); None when one is not a
    number."""
    try:
        if kind == 'int':
            return np.fromiter(map(int, items), np.int64, len(items))
        if kind == 'float':
            return np.fromiter(map(float, items), np.float64, len(items))
        return np.asarray([int(x) if _INT_ITEM_RE.fullmatch(x.strip())
                           else float(x) for x in items], dtype=np.float64)
    except ValueError:
        return None


def _numeric_array(body):
    """The array of a ``[...]`` body of numbers, or of rows ``(...)`` of
    numbers, as the token-by-token parse gives it (int64 when every number
    is an integer, else float64); None for any other body, which the
    token-by-token parse then reads."""
    if not _NUMERIC_BODY_RE.fullmatch(body):
        return None
    kind = ('int' if not any(c in body for c in '.eE') else
            'mixed' if _INT_AMONG_RE.search(body) else 'float')
    if kind == 'int' and _LONG_INT_RE.search(body):
        return None
    if '(' not in body:
        if not body.strip():
            return np.asarray([])
        items = body.split(',')
        if not items[-1].strip():       # a trailing comma
            items.pop()
        return _numbers(items, kind)
    if _SEPARATORS_RE.fullmatch(_ROW_RE.sub('', body)) is None:
        return None
    rows = [r.split(',') for r in _ROW_RE.findall(body)]
    for r in rows:
        if not r[-1].strip():
            r.pop()
    width = len(rows[0])
    if width == 0 or any(len(r) != width for r in rows):
        return None
    flat = _numbers([x for r in rows for x in r], kind)
    return None if flat is None else flat.reshape(len(rows), width)


class _Parser:
    """Reads tokens from the text as it goes; a ``[...]`` array of numbers
    is read in one step (:func:`_numeric_array`), any other value token by
    token."""

    def __init__(self, text):
        self.text = text
        self.pos = 0
        self.tok = self.start = None
        self._advance()

    def _advance(self):
        text, n = self.text, len(self.text)
        while True:
            m = _TOKEN_RE.search(text, self.pos)
            if m is None:
                self.tok, self.start, self.pos = None, n, n
                return
            self.pos = m.end()
            if not m.group(0).startswith('#'):
                self.tok, self.start = m.group(0), m.start()
                return

    def peek(self):
        return self.tok

    def next(self):
        if self.tok is None:
            raise IndexError('unexpected end of the usda document')
        tok = self.tok
        self._advance()
        return tok

    def expect(self, tok):
        got = self.next()
        if got != tok:
            raise ValueError(f'expected {tok!r}, got {got!r} at '
                             f'{self.start}')

    def parse_stage(self):
        stage = UsdaStage()
        if self.peek() == '(':
            self.next()
            depth = 1
            while depth:
                tok = self.next()
                if tok == '(':
                    depth += 1
                elif tok == ')':
                    depth -= 1
        while self.peek() is not None:
            if self.peek() in ('def', 'over', 'class'):
                stage.root.children.append(self.parse_prim(stage.root))
            else:
                self.next()
        return stage

    def parse_prim(self, parent):
        self.next()  # def/over/class
        type_name = ''
        if not self.peek().startswith('"'):
            type_name = self.next()
        name = self.next().strip('"')
        prim = UsdaPrim(name, type_name, parent)
        if self.peek() == '(':  # prim metadata — skip
            self.next()
            depth = 1
            while depth:
                tok = self.next()
                if tok == '(':
                    depth += 1
                elif tok == ')':
                    depth -= 1
        self.expect('{')
        while self.peek() != '}':
            if self.peek() in ('def', 'over', 'class'):
                prim.children.append(self.parse_prim(prim))
            else:
                self.parse_attr(prim)
        self.expect('}')
        return prim

    def parse_attr(self, prim):
        words = []
        # collect type + name tokens until '=' or '{'-style timeSamples
        while self.peek() not in ('=',):
            words.append(self.next())
            if len(words) > 8:
                raise ValueError(f'cannot parse attribute near {words}')
        self.expect('=')
        # rejoin namespaced attribute names the tokenizer split on ':'
        # (e.g. ['float2[]', 'primvars', ':', 'st'] -> 'primvars:st')
        parts = [words.pop()]
        while len(words) >= 2 and words[-1] == ':':
            words.pop()
            parts.insert(0, words.pop())
        name = ':'.join(parts)
        if name.endswith('.timeSamples'):
            base = name[:-len('.timeSamples')]
            self.expect('{')
            samples = TimeSampled()
            while self.peek() != '}':
                t = float(self.next())
                self.expect(':')
                samples[t] = self.parse_value()
                if self.peek() == ',':
                    self.next()
            self.expect('}')
            prim.attrs[base] = samples
        else:
            val = self.parse_value()
            if self.peek() == '(':  # attribute metadata — skip
                self.next()
                depth = 1
                while depth:
                    tok = self.next()
                    if tok == '(':
                        depth += 1
                    elif tok == ')':
                        depth -= 1
            prim.attrs[name] = val

    def parse_value(self):
        tok = self.peek()
        if tok == '[':
            end = self.text.find(']', self.start)
            arr = (None if end < 0 else
                   _numeric_array(self.text[self.start + 1:end]))
            if arr is not None:
                self.pos = end + 1
                self._advance()
                return arr
            self.next()
            items = []
            while self.peek() != ']':
                items.append(self.parse_value())
                if self.peek() == ',':
                    self.next()
            self.expect(']')
            return np.asarray(items)
        if tok == '(':
            self.next()
            items = []
            while self.peek() != ')':
                items.append(self.parse_value())
                if self.peek() == ',':
                    self.next()
            self.expect(')')
            return np.asarray(items)
        tok = self.next()
        if tok.startswith('"'):
            return tok.strip('"')
        if tok in ('true', 'false'):
            return tok == 'true'
        try:
            if re.fullmatch(r'[+-]?\d+', tok):
                return int(tok)
            return float(tok)
        except ValueError:
            return tok


def parse_usda(text):
    """Parse a USDA document (subset) into a :class:`UsdaStage`."""
    if not text.lstrip().startswith('#usda'):
        raise ValueError('not a usda document')
    return _Parser(text).parse_stage()
