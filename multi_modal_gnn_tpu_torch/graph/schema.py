"""Node and edge-type names of the EHR graph (copy of the JAX package's
``graph/schema.py``): four node types and three forward relations, each
mirrored by a reverse relation."""

from __future__ import annotations

from typing import Tuple

EdgeTypeKey = Tuple[str, str, str]  # (src_node_type, relation, dst_node_type)

PATIENT = "patient"
LAB = "lab"
DIAGNOSIS = "diagnosis"
MEDICATION = "medication"

NODE_TYPES: Tuple[str, ...] = (PATIENT, LAB, DIAGNOSIS, MEDICATION)

PATIENT_LAB: EdgeTypeKey = (PATIENT, "has_lab", LAB)
PATIENT_DIAGNOSIS: EdgeTypeKey = (PATIENT, "has_diagnosis", DIAGNOSIS)
PATIENT_MEDICATION: EdgeTypeKey = (PATIENT, "has_medication", MEDICATION)

FORWARD_EDGE_TYPES: Tuple[EdgeTypeKey, ...] = (
    PATIENT_LAB,
    PATIENT_DIAGNOSIS,
    PATIENT_MEDICATION,
)

# config section name (graph.edge_types.<name>) -> forward relation
CONFIG_EDGE_NAMES = {
    "patient_lab": PATIENT_LAB,
    "patient_diagnosis": PATIENT_DIAGNOSIS,
    "patient_medication": PATIENT_MEDICATION,
}

REV_PREFIX = "rev_"


def reverse_edge_type(edge_type: EdgeTypeKey) -> EdgeTypeKey:
    """(p, has_lab, l) -> (l, rev_has_lab, p)."""
    src, rel, dst = edge_type
    return (dst, REV_PREFIX + rel, src)


def is_reverse(edge_type: EdgeTypeKey) -> bool:
    return edge_type[1].startswith(REV_PREFIX)


def mirror_edge_type(edge_type: EdgeTypeKey) -> EdgeTypeKey:
    """The relation with src/dst swapped: forward <-> reverse (involution)."""
    src, rel, dst = edge_type
    if rel.startswith(REV_PREFIX):
        return (dst, rel[len(REV_PREFIX):], src)
    return (dst, REV_PREFIX + rel, src)
