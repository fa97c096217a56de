// Greedy chaining of localizations into binding events, on the host.
//
// Replaces the walk of picasso_tpu/native/picasso_native.cpp:38-80
// (link_groups). That loop scans, for each loc that extends a chain,
// every loc of the next max_dark_time + 1 frames and tests its distance;
// here ops/link.py has found each loc's successors on the card already
// (locs of its group in that window within d_max, ascending), so the
// walk touches about 2 successors a loc. It is a sequential pointer
// chase bound by the host's memory latency: no device code, built into
// the kernel library with the rest.
//
// offsets: (n + 1) int64, succ: (offsets[n]) int64, the CSR of
//          successors, each row ascending;
// out:     (n) int32 chain ids (written): a loc without a chain starts
//          one, and the chain claims the first successor still unclaimed.
// Returns 0.

extern "C" int picasso_link_walk(const long long* offsets,
                                 const long long* succ, long long n,
                                 int* out) {
  for (long long i = 0; i < n; ++i) out[i] = -1;
  int current = -1;
  for (long long i = 0; i < n; ++i) {
    if (out[i] != -1) continue;
    out[i] = ++current;
    long long ci = i;
    for (;;) {
      long long next = -1;
      for (long long k = offsets[ci]; k < offsets[ci + 1]; ++k) {
        if (out[succ[k]] == -1) {
          next = succ[k];
          break;
        }
      }
      if (next < 0) break;
      out[next] = current;
      ci = next;
    }
  }
  return 0;
}
