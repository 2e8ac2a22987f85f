// Shared by the frontier auction kernels: K2 and K16's segment launch
// (auction.cu) and K16's three launches a round (mesh_auction.cu). The
// loop state's layout, the constants of frontier_bids, and the limits of
// the segment launch. kernels.py mirrors Ctl as its CTL_* and the limits
// as MESH_SEGMENT_MAX_SHARDS / MESH_SEGMENT_OPEN_BYTES (the route decides
// from them without a card); tests/test_torch_mesh.py holds the mirror to
// this file.

#pragma once

namespace {

// a shard's loop state and counts, int32 [kCtl]: the loop's it, best and
// stall, whether this round runs (go) and has counts to fold (pending),
// the frontier size nb, the frontier rows bid so far, and the shard's
// open and assigned counts
enum Ctl { kIt, kBest, kStall, kGo, kPending, kNb, kRows, kOpen, kAssigned, kCtl };

constexpr int kMaxSlots = 4;  // candidate values each lane keeps: K <= 128
constexpr float kNeg = -1e18f;
constexpr float kHalfNeg = -5e17f;  // _NEG * 0.5
constexpr float kV2Floor = -1e8f;

// the segment launch: the shards one launch takes, and the shared memory
// its open bitmask may take in one block (200 KB holds 1,638,400 rows, less
// a word's padding a shard, at any cluster size)
constexpr int kMaxShards = 32;
constexpr int kMaxOpenBytes = 200 * 1024;

}  // namespace
