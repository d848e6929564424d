// bq_sim.cuh: QuIVer Table 1's similarity of one 32-bit word pair, shared by
// the kernels in bq_distance.cu and list_scan.cu.
//
// pa/sa and pb/sb are the sign ("positive") and strong planes of the two
// words, m the word's valid-bit mask.  Each valid bit scores +-4 (both
// strong), +-2 (one strong) or +-1 (both weak), positive where the signs
// agree; padding bits are 0 in both planes and masked out.

#pragma once

#include <stdint.h>

__device__ __forceinline__ int sim_word(uint32_t pa, uint32_t sa, uint32_t pb,
                                        uint32_t sb, uint32_t m) {
  const uint32_t diff = pa ^ pb;  // padding bits are 0 in both planes
  const uint32_t same = ~diff & m;
  const uint32_t both_strong = sa & sb;
  const uint32_t one_strong = sa ^ sb;
  const uint32_t both_weak = ~(sa | sb) & m;
  return 4 * __popc(same & both_strong) + 2 * __popc(same & one_strong) +
         __popc(same & both_weak) - 4 * __popc(diff & both_strong) -
         2 * __popc(diff & one_strong) - __popc(diff & both_weak);
}
