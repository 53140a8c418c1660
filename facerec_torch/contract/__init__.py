"""The file data contract (layer L3 of the reference).

All inter-stage communication is through files in ``<out>/<movie_id>-data/``;
these modules read and write them byte-compatibly with the reference so
the downstream video-labeler backend keeps working
(cf. reference README.md:3 and SURVEY.md §2.2).
"""
from facerec_torch.contract.jsonio import dump_compact, dumps_compact
from facerec_torch.contract.naming import (
    movie_id_from_filename,
    shard_file_name,
    box_tag,
    MovieDirs,
)
from facerec_torch.contract import records
