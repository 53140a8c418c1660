"""Actor reference database builder.

Port of ``facerec_tpu/pipeline/actors.py``: queries the MoMaF knowledge
graph for a film's actors and their image URLs (SPARQL over HTTP),
downloads each image, keeps those with exactly one detected face,
embeds them with all four FaceNet checkpoints and caches image + JSON
sidecar incrementally into ``actor-images.zip`` (the file the classify
stage reads).  Same-film images come first, then others; the zip
manifest makes the process resumable.

Network access is injected (``fetch`` / ``sparql``), and so is the
image decoder: its default, ``cv2.imdecode``, is imported only when it
is called, so a host without OpenCV passes its own.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import zipfile
from typing import Callable, List, Optional

import numpy as np
import torch

from facerec_torch.config import FACE_IMAGE_SIZE
from facerec_torch.ops.boxes import round_clip_box
from facerec_torch.ops.crops import crop_resize
from facerec_torch.pipeline.faces import embed_crop_box
from facerec_torch.runtime.device import resolve_device, use_full_float32

SPARQL_URL = "http://momaf-data.utu.fi:3030/momaf-raw/sparql"

FILM_QUERY = """
PREFIX skos: <http://www.w3.org/2004/02/skos/core#>
PREFIX rdf: <http://www.w3.org/1999/02/22-rdf-syntax-ns#>
PREFIX rdfs: <http://www.w3.org/2000/01/rdf-schema#>
PREFIX momaf: <http://momaf-data.utu.fi/>

SELECT ?filmURI ?filmID ?filmname ?actorURI ?actorID (sample(?a) as ?actorname)
WHERE {
  ?filmURI a momaf:Movie ;
          momaf:elonet_movie_ID <FILM>, ?filmID ;
          skos:prefLabel ?filmname ;
          momaf:hasMember [
            a momaf:Actor ;
            momaf:hasAgent ?actorURI
          ] .
  ?actorURI a momaf:Person ;
          momaf:elonet_person_ID ?actorID ;
          skos:prefLabel ?a .
} GROUP BY ?filmURI ?filmID ?filmname ?actorURI ?actorID
"""

ACTOR_QUERY = """
PREFIX skos: <http://www.w3.org/2004/02/skos/core#>
PREFIX rdf: <http://www.w3.org/1999/02/22-rdf-syntax-ns#>
PREFIX rdfs: <http://www.w3.org/2000/01/rdf-schema#>
PREFIX momaf: <http://momaf-data.utu.fi/>

SELECT ?actorURI ?actorID (sample(?a) as ?actorname)
       ?imageURI ?image_url ?filename ?filmURI ?filmID ?filmname
WHERE {
  ?actorURI a momaf:Person ;
          momaf:elonet_person_ID <ACTOR>, ?actorID ;
          skos:prefLabel ?a .
  ?imageURI a momaf:Image ;
          momaf:hasMember [ momaf:hasAgent ?actorURI ] ;
          momaf:sourcefile ?image_url ;
          skos:prefLabel ?filename ;
          momaf:hasMember [ momaf:hasAgent ?filmURI ] .
  ?filmURI a momaf:Movie ;
          momaf:elonet_movie_ID <FILM> , ?filmID ;
          skos:prefLabel ?filmname .
} GROUP BY ?filmURI ?filmID ?filmname ?actorURI ?actorID ?imageURI ?image_url ?filename
"""


def default_sparql_query(query: str) -> dict:
    """POST a SPARQL query, return parsed JSON bindings."""
    import urllib.parse
    import urllib.request

    data = urllib.parse.urlencode({"query": query}).encode()
    req = urllib.request.Request(
        SPARQL_URL, data=data,
        headers={"Accept": "application/sparql-results+json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def default_fetch_url(url: str) -> Optional[bytes]:
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.read()
    except OSError as e:              # URLError is an OSError
        print(f"FAILED to retrieve {url} : {e}")
        return None


def default_decode(image_bytes: bytes) -> Optional[np.ndarray]:
    """Encoded image → (H, W, 3) uint8 RGB with OpenCV, or None."""
    import cv2

    img = cv2.imdecode(np.frombuffer(image_bytes, np.uint8),
                       cv2.IMREAD_COLOR)
    if img is None:
        return None
    return np.ascontiguousarray(img[..., ::-1])  # BGR → RGB


def _digits(value) -> str:
    if isinstance(value, int):
        return str(value)
    m = re.search(r"(\d+)", str(value))
    if not m:
        raise ValueError(f"No digits in <{value}>")
    return m.group(1)


def _bindings(results: dict, keys: List[str]) -> List[dict]:
    out = []
    for res in results["results"]["bindings"]:
        out.append({k: res[k]["value"] if k in res else None for k in keys})
    return out


def fetch_actor_list(film, sparql: Callable = default_sparql_query):
    q = FILM_QUERY.replace("<FILM>", f'"{_digits(film)}"')
    keys = [a + b for a in ("film", "actor") for b in ("URI", "ID", "name")]
    return _bindings(sparql(q), keys)


def fetch_actor_image_urls(actor, film,
                           sparql: Callable = default_sparql_query):
    film_term = "?film" if film is None else f'"{_digits(film)}"'
    q = (ACTOR_QUERY.replace("<ACTOR>", f'"{_digits(actor)}"')
         .replace("<FILM>", film_term))
    keys = ([a + b for a in ("film", "actor")
             for b in ("URI", "ID", "name")]
            + ["imageURI", "image_url", "filename"])
    return _bindings(sparql(q), keys)


class FaceEmbedderForImages:
    """Single-image detect+embed on one device: exactly-one-face gate,
    tight box, four-checkpoint embeddings.  The detector runs at
    (512, 512) with 8 detections, threshold 0.95 and min face 20."""

    def __init__(self, detector=None, embedders=None,
                 detector_weights: Optional[str] = None,
                 facenet_weights: Optional[str] = None, device=None,
                 decode: Callable[[bytes], Optional[np.ndarray]] =
                 default_decode):
        self.device = resolve_device(device)
        use_full_float32()
        self._detector = detector
        self._embedders = embedders
        self._detector_weights = detector_weights
        self._facenet_weights = facenet_weights
        self.decode = decode

    @property
    def detector(self):
        if self._detector is None:
            from facerec_torch.models.detector import DetectorHarness
            from facerec_torch.models.load import warn_random_init

            kwargs = dict(input_size=(512, 512), max_detections=8,
                          score_threshold=0.95, min_face_size=20)
            if self._detector_weights is not None:
                self._detector = DetectorHarness.from_npz(
                    self._detector_weights, device=self.device, **kwargs)
            else:
                warn_random_init("The face detector", "--detector-weights")
                self._detector = DetectorHarness.create(device=self.device,
                                                        **kwargs)
        return self._detector

    @property
    def embedders(self):
        if self._embedders is None:
            from facerec_torch.pipeline.extract import build_embedders

            self._embedders = build_embedders(self._facenet_weights,
                                              self.device)
        return self._embedders

    @torch.inference_mode()
    def __call__(self, image_bytes: bytes) -> Optional[dict]:
        img = self.decode(image_bytes)
        if img is None:
            return None
        h, w = img.shape[:2]
        frames = torch.from_numpy(np.ascontiguousarray(img)[None]).to(
            self.device)

        det = self.detector(frames)
        valid = det.valid[0].cpu().numpy()
        if valid.sum() != 1:
            return None
        box = det.boxes[0].cpu().numpy()[valid.argmax()]

        tight = round_clip_box(box, w, h)
        crop_box = embed_crop_box(tight, w, h)
        crops = crop_resize(
            frames, torch.zeros(1, dtype=torch.int64, device=self.device),
            torch.from_numpy(crop_box[None]).to(self.device),
            FACE_IMAGE_SIZE)
        embeddings = {name: vecs[0].tolist()
                      for name, vecs in self.embedders(crops).items()}
        return {"box": tight, "embeddings": embeddings}


def prepare_one_actor(actor: dict, n_images: int, zip_path: str,
                      embed: FaceEmbedderForImages,
                      sparql: Callable = default_sparql_query,
                      fetch: Callable = default_fetch_url) -> List[dict]:
    """Cache up to ``n_images`` embedded faces for one actor, resuming
    from what is already in the zip."""
    existing = []
    if os.path.isfile(zip_path):
        with zipfile.ZipFile(zip_path) as z:
            existing = z.namelist()
    os.makedirs(os.path.dirname(zip_path) or ".", exist_ok=True)

    fid, aid, aname = actor["filmID"], actor["actorID"], actor["actorname"]
    images = fetch_actor_image_urls(aid, None, sparql)
    faces: List[dict] = []

    with zipfile.ZipFile(zip_path, "a") as zf:
        # same-film images first, then others
        for same_film in (True, False):
            for img in images:
                if same_film != (img["filmID"] == fid):
                    continue
                iname = img["filename"]
                jname = iname + ".json"
                have_json = jname in existing
                have_image = iname in existing
                idata = None
                if not have_image:
                    idata = fetch(img["image_url"])
                    if idata is None:
                        continue
                    zf.writestr(iname, idata)
                    existing.append(iname)
                elif not have_json:
                    idata = zf.read(iname)

                if not have_json:
                    face = embed(idata)
                    if face is None:
                        face = {"note": "no unique face"}
                    else:
                        face["actorID"] = aid
                        face["actorname"] = aname
                    face["filmID"] = img["filmID"]
                    face["filmname"] = img["filmname"]
                    face["image_url"] = img["image_url"]
                    face["filename"] = iname
                    zf.writestr(jname, json.dumps(face))
                    existing.append(jname)
                else:
                    face = json.loads(zf.read(jname))
                if "box" in face:
                    faces.append(face)
                if len(faces) >= n_images:
                    return faces
            if len(faces) >= n_images:
                break
    return faces


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="Collect actor face embeddings for a film.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card) or cpu")
    parser.add_argument("--film", type=str, required=True)
    parser.add_argument("--actors-dir", type=str, default=".")
    parser.add_argument("--n-faces", type=int, default=20)
    parser.add_argument("--path", type=str, default=".")
    parser.add_argument("--facenet-weights", type=str, default=None,
                        help="directory with the four FaceNet "
                             "checkpoints (see extract --help)")
    parser.add_argument("--detector-weights", type=str, default=None,
                        help="single-file Flax .npz detector checkpoint")
    args = parser.parse_args(argv)

    actors = fetch_actor_list(args.film)
    if not actors:
        print(f"No actors found for film <{args.film}>")
        return 1

    zipf = os.path.join(args.actors_dir, "actor-images.zip")
    embed = FaceEmbedderForImages(
        detector_weights=args.detector_weights,
        facenet_weights=args.facenet_weights, device=args.device)
    faces = []
    for a in actors:
        faces.extend(prepare_one_actor(a, args.n_faces, zipf, embed))

    if not faces:
        print(f"No actor faces found for film <{args.film}>")
        return 1

    out = os.path.join(args.path,
                       f"actor-faces-{actors[0]['filmID']}.json")
    with open(out, "w") as f:
        json.dump(faces, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
