"""JAAD / PIE annotation XML -> ``annotations.csv``, with exactly the
columns the OpenPose datamodules read (``JAAD_USECOLS`` / ``PIE_USECOLS``),
through the standard library's ElementTree.

Both datasets use the CVAT-style schema: ``annotations/<video>.xml`` with
``<track label=...><box frame=.. xtl=.. ytl=.. xbr=.. ybr=..><attribute
name=...>``, and per-video attribute files for the pedestrians' age,
gender and crossing point. ``pandas`` is imported inside ``generate_df``.
"""
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional


def _box_attributes(box) -> Dict[str, str]:
    return {a.get("name"): (a.text or "") for a in box.findall("attribute")}


def _parse_video_xml(path: str) -> List[Dict]:
    root = ET.parse(path).getroot()
    meta = root.find("meta")
    width = height = 0
    if meta is not None:
        size = meta.find(".//original_size")
        if size is not None:
            width = int(float(size.findtext("width", "0")))
            height = int(float(size.findtext("height", "0")))
    rows = []
    for track in root.findall("track"):
        label = track.get("label", "")
        track_id = track.get("id", "")
        for box in track.findall("box"):
            attrs = _box_attributes(box)
            rows.append({
                "label": label,
                "track_id": attrs.get("id", track_id),
                "frame": int(box.get("frame")),
                "x1": float(box.get("xtl")), "y1": float(box.get("ytl")),
                "x2": float(box.get("xbr")), "y2": float(box.get("ybr")),
                "occlusion": attrs.get("occlusion", ""),
                "cross": attrs.get("cross", ""),
                "video_width": width, "video_height": height,
            })
    return rows


def _parse_attributes_xml(path: str) -> Dict[str, Dict[str, str]]:
    """``<ped_attributes><pedestrian id=... age=... gender=...
    crossing=... crossing_point=...>`` -> per-pedestrian dict."""
    if not os.path.exists(path):
        return {}
    root = ET.parse(path).getroot()
    out = {}
    for ped in root.iter("pedestrian"):
        out[ped.get("id")] = dict(ped.attrib)
    return out


class AnnotationsXml2Csv:
    """Base converter; subclasses pin dataset layout."""

    def __init__(self, annotations_dir: str, output_path: str):
        self.annotations_dir = annotations_dir
        self.output_path = output_path
        self.sets: List[str] = [""]

    def _video_rows(self, set_name: str, video_id: str,
                    xml_path: str) -> List[Dict]:
        attributes = _parse_attributes_xml(os.path.join(
            self.annotations_dir, "annotations_attributes",
            f"{video_id}_attributes.xml"))
        rows = []
        for r in _parse_video_xml(xml_path):
            ped_id = r["track_id"]
            attrs = attributes.get(ped_id, {})
            rows.append({
                "set_name": set_name,
                "video": video_id,
                "frame": r["frame"],
                "x1": r["x1"], "y1": r["y1"], "x2": r["x2"], "y2": r["y2"],
                "id": ped_id,
                "age": attrs.get("age", "adult"),
                "gender": attrs.get("gender", ""),
                "crossing": attrs.get("crossing", "0"),
                "crossing_point": int(attrs.get("crossing_point", -1)),
                "beh": r["label"] == "pedestrian",
                "video_width": r["video_width"],
                "video_height": r["video_height"],
            })
        return rows

    def generate_df(self):
        import pandas as pd

        all_rows: List[Dict] = []
        for set_name in self.sets:
            ann_dir = os.path.join(self.annotations_dir, "annotations",
                                   set_name)
            if not os.path.isdir(ann_dir):
                continue
            for fn in sorted(os.listdir(ann_dir)):
                if not fn.endswith(".xml"):
                    continue
                video_id = os.path.splitext(fn)[0]
                all_rows.extend(self._video_rows(
                    set_name, video_id, os.path.join(ann_dir, fn)))
        df = pd.DataFrame(all_rows)
        os.makedirs(os.path.dirname(self.output_path), exist_ok=True)
        df.to_csv(self.output_path, index=False)
        return df


class JAADAnnotationsXml2Csv(AnnotationsXml2Csv):
    def __init__(self, annotations_dir: str = "datasets/JAAD",
                 output_path: Optional[str] = None):
        super().__init__(annotations_dir,
                         output_path or os.path.join(annotations_dir,
                                                     "annotations.csv"))
        self.sets = [""]  # JAAD has no sets


class PIEAnnotationsXml2Csv(AnnotationsXml2Csv):
    def __init__(self, annotations_dir: str = "datasets/PIE",
                 output_path: Optional[str] = None):
        super().__init__(annotations_dir,
                         output_path or os.path.join(annotations_dir,
                                                     "annotations.csv"))
        self.sets = [f"set{i:02d}" for i in range(1, 7)]
