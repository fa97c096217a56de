// The label sweep of the SMLM clusterer, on the host.
//
// Replaces the sweep of picasso_tpu/native/picasso_native.cpp:392-417
// (cluster_smlm) and :433-456 (cluster_label_sweep). ops/neighbors.py has
// counted the neighbours, found the local maxima and listed each maximum's
// neighbours on the card; what is left is sequential: maxima are taken in
// ascending index, an unassigned maximum overwrites its whole
// neighbourhood with its own number, an assigned one only fills its
// unassigned neighbours. No device code; built into the kernel library
// with the rest, as csrc/link_walk.cu is.
//
// lm_idx:       (m) int64, the local maxima in ascending index;
// starts/stops: (m) int64, the CSR range of each maximum's neighbours in
//               cols (the maximum itself need not be listed);
// labels:       (n) int32, -1 on entry; a maximum's number is its
//               position k in lm_idx, so every maximum counts and the
//               numbers are not compacted.
// Returns 0.

extern "C" int picasso_cluster_sweep(const long long* lm_idx,
                                     const long long* starts,
                                     const long long* stops,
                                     const long long* cols, long long m,
                                     int* labels) {
  for (long long k = 0; k < m; ++k) {
    const long long i = lm_idx[k];
    const int label = labels[i];
    if (label == -1) {
      const int mine = static_cast<int>(k);
      for (long long p = starts[k]; p < stops[k]; ++p) labels[cols[p]] = mine;
      labels[i] = mine;
    } else {
      for (long long p = starts[k]; p < stops[k]; ++p) {
        if (labels[cols[p]] == -1) labels[cols[p]] = label;
      }
    }
  }
  return 0;
}
