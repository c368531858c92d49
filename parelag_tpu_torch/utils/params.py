"""Hierarchical typed configuration: ParameterList + XML reader.

Rebuild of the reference's Teuchos-style ParameterList
(src/utilities/ParELAG_ParameterList.hpp:29-145) and
SimpleXMLParameterListReader (ParELAG_SimpleXMLParameterListReader.cpp):
a nested typed key->value tree with sublists; Get(name, default) inserts the
default when missing; unknown parameters are silently ignored by consumers
(by design — see the header comment in
examples/example_parameterlists/darcy_example_parameters.xml:1-6).
Reads the reference's exact XML schema (<ParameterList>/<Parameter
name type value>) plus plain Python dicts.
"""

import xml.etree.ElementTree as ET


class ParameterList:
    def __init__(self, name="ANONYMOUS", data=None):
        self.name = name
        self._data = {}
        if data:
            for k, v in data.items():
                if isinstance(v, dict):
                    self._data[k] = ParameterList(k, v)
                else:
                    self._data[k] = v

    # ------------------------------------------------------------------ #
    def get(self, key, default=None):
        """Get<T>(name, default): inserts the default when absent
        (ParELAG_ParameterList.hpp:129-145)."""
        if key not in self._data and default is not None:
            self._data[key] = default
        return self._data.get(key, default)

    def set(self, key, value):
        self._data[key] = value

    def sublist(self, key, create=True):
        if key not in self._data:
            if not create:
                raise KeyError(key)
            self._data[key] = ParameterList(key)
        sub = self._data[key]
        assert isinstance(sub, ParameterList), f"{key} is not a sublist"
        return sub

    def has(self, key):
        return key in self._data

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def __contains__(self, key):
        return key in self._data

    def __repr__(self):
        return f"ParameterList({self.name!r}, {self._data!r})"

    def to_dict(self):
        return {k: (v.to_dict() if isinstance(v, ParameterList) else v)
                for k, v in self._data.items()}


_CONVERTERS = {
    "int": int,
    "double": float,
    "string": str,
    "bool": lambda s: s.strip().lower() in ("true", "1", "yes"),
    "vector(int)": lambda s: [int(x) for x in s.split()],
    "vector_int": lambda s: [int(x) for x in s.split()],
    "vector_double": lambda s: [float(x) for x in s.split()],
    "vector(double)": lambda s: [float(x) for x in s.split()],
    "list(int)": lambda s: [int(x) for x in s.split()],
    "list(string)": lambda s: s.split(),
}


def read_xml(path_or_string) -> ParameterList:
    """Parse the reference XML parameter schema into a ParameterList."""
    if "<" in str(path_or_string):
        root = ET.fromstring(path_or_string)
    else:
        root = ET.parse(path_or_string).getroot()
    assert root.tag == "ParameterList"
    return _parse_list(root)


def _parse_list(node) -> ParameterList:
    out = ParameterList(node.get("name", "ANONYMOUS"))
    for child in node:
        if child.tag == "ParameterList":
            out.set(child.get("name"), _parse_list(child))
        elif child.tag == "Parameter":
            conv = _CONVERTERS.get(child.get("type", "string"), str)
            out.set(child.get("name"), conv(child.get("value")))
    return out
