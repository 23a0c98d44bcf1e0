"""JSON io helpers (unidefense_tpu/utils/io.py:11-22) — API parity with the reference's utils/io.py:1-27
(load_from_json / write_to_json, re-exported from utils.*). The reference
never calls them from its engines, but they are part of its public utils
surface, so users importing them keep working here."""

from __future__ import annotations

import json


def load_from_json(filename: str):
    """Load a dictionary from a JSON file (utils/io.py:8-16)."""
    assert filename.endswith(".json")
    with open(filename, encoding="UTF-8") as file:
        return json.load(file)


def write_to_json(filename: str, content: dict) -> None:
    """Write a dictionary to a JSON file (utils/io.py:19-27)."""
    assert filename.endswith(".json")
    with open(filename, "w", encoding="UTF-8") as file:
        json.dump(content, file)
