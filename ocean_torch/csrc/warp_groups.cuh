// Warp grouping by key, shared by the two scatter kernels
// (point_sources.cu: key = grid square; segment_sum.cu: key = cell id).
//
// The points arrive in trajectory order, so the 32 lanes of a warp fall
// into a few keys. Lanes with one key form a group; a group's integer
// terms are summed over the warp first and added to the counters once.
// The partition is computed once per 32 points with one match
// instruction and then walked group by group.
#pragma once

#define FULL_MASK 0xffffffffu

// Each live lane gets the mask of the live lanes that share its key
// (key >= 0 on live lanes); a lane that is not live gets 0. Every lane of
// the warp must call it.
__device__ __forceinline__ unsigned lanes_sharing_key(bool live,
                                                      long long key) {
    const unsigned same = __match_any_sync(FULL_MASK, live ? key : -1LL);
    return live ? same : 0u;
}

// Takes the group of the lowest lane still in `todo` off `todo` and
// returns its lane mask; `leader` is that lane. Every lane must call it
// (todo is uniform over the warp).
__device__ __forceinline__ unsigned next_group(unsigned& todo, unsigned mine,
                                               int& leader) {
    leader = __ffs(todo) - 1;
    const unsigned group = __shfl_sync(FULL_MASK, mine, leader);
    todo &= ~group;
    return group;
}
