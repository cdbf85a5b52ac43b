// Native PDB ATOM-record formatter.
//
// Copied from the JAX package's csrc/pdb_formatter.cc (bound there by
// pmhc_tpu/io/pdb_native.py); the port's binding is
// pmhc_tpu_torch/io/pdb_native.py, built by pmhc_tpu_torch/ops/_build.py.
//
// Byte-exact twin of pmhc_tpu/io/pdb.py::_atom_record (asserted by
// tests/unit/test_pdb_native_formatter.py): the sampling CLI's host wall
// after the strided sampler landed is f-string formatting of ~1350 atom
// records per entry (~6.8 ms/entry profiled, 61% of save_pdb). snprintf
// over packed arrays cuts that to ~0.1 ms.
//
// Field layout per PDBIO's _ATOM_FORMAT_STRING, matching the Python
// writer exactly (reference: the reference's diffusion/tools/pdb.py via
// BioPython's PDBIO; occupancy 1.00 / bfactor 0.00, segid = chain id):
//   "ATOM  {serial:>5} {name4} {res:>3} {chain}{resseq:>4}    "
//   "{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00      {chain:>4}{elem:>2}  \n"
// Both Python's format() and glibc's snprintf produce correctly-rounded
// shortest-width decimal for %8.3f, so the bytes agree (tested across
// random/negative/large coordinates).

#include <cstdio>
#include <cstring>

extern "C" {

// Format n ATOM records into out (capacity out_cap bytes).
// names4: n*4 bytes (pre-padded name field), resnames3: n*3 bytes,
// elements2: n*2 bytes (right-justified), xyz: n*3 doubles.
// serials/resseqs: per-record ints; chain: single chain id char.
// Returns bytes written, or -1 if out_cap would be exceeded.
long pmhc_format_atoms(int n, const int* serials, const int* resseqs,
                       char chain, const char* names4,
                       const char* resnames3, const char* elements2,
                       const double* xyz, char* out, long out_cap) {
  long pos = 0;
  for (int i = 0; i < n; ++i) {
    int w = snprintf(
        out + pos, (size_t)(out_cap - pos),
        "ATOM  %5d %.4s %.3s %c%4d    %8.3f%8.3f%8.3f  1.00  0.00"
        "      %4c%.2s  \n",
        serials[i], names4 + 4 * i, resnames3 + 3 * i, chain, resseqs[i],
        xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2], chain,
        elements2 + 2 * i);
    if (w < 0 || pos + w >= out_cap) return -1;
    pos += w;
  }
  return pos;
}

}  // extern "C"
