from pmhc_tpu_torch.io.pdb import (
    convert_batch_for_pdb,
    fetch_pdb_arrays,
    pdb_bytes,
    precompute_pdb_arrays,
    save_pdb,
)

__all__ = ["convert_batch_for_pdb", "fetch_pdb_arrays", "pdb_bytes", "precompute_pdb_arrays",
           "save_pdb"]
