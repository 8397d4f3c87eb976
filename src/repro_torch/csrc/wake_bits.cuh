// The wake bits of the masked ΔGRU instantiations (csrc/delta_gru_seq.cu,
// csrc/delta_gru_seq_int.cu, template argument kMasked): the stage-1 half
// of the two-stage wake cascade runs a slot's frame only where the (T, B)
// uint8 wake trace says the slot is awake.  A CTA is one stream, so its
// column of the trace decides, frame by frame, whether the whole CTA runs
// the frame: the test is uniform across the CTA, and an asleep frame skips
// the frame's barriers with its work.
//
// Every warp keeps the bits of 32 frames in one register, made from one
// byte per lane by a ballot; the bytes of the next 32 frames are loaded a
// block ahead, so no load waits on the frame chain.  Every warp holds the
// same word.  Nothing goes to shared memory: the masked instantiation
// launches with the unmasked one's plan.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wake {

struct Bits {
  unsigned word;  // bit f: frame t0 + f is awake (t0 the block's first)
  int next;       // this lane's byte of frame t0 + 32 + lane
};

// The byte of frame t of stream b; 0 past the last frame.
__device__ __forceinline__ int byte_at(const uint8_t* awake, int t, int T,
                                       int B, int b) {
  return t < T ? awake[static_cast<size_t>(t) * B + b] : 0;
}

// The prologue: the bits of frames 0..31 and this lane's byte of frame 32
// + lane.  Every lane of the warp must call it.
__device__ __forceinline__ Bits first(const uint8_t* awake, int T, int B,
                                      int b, int lane) {
  Bits w;
  const int cur = byte_at(awake, lane, T, B, b);
  w.next = byte_at(awake, 32 + lane, T, B, b);
  w.word = __ballot_sync(0xffffffffu, cur != 0);
  return w;
}

// Whether frame t is awake.  At the first frame of each later block of 32
// the word is made from the bytes loaded a block before, and the next
// block's bytes are loaded.  Every lane of the warp must call it, at every
// frame, in order.
__device__ __forceinline__ bool is_awake(Bits& w, const uint8_t* awake,
                                         int t, int T, int B, int b,
                                         int lane) {
  if ((t & 31) == 0 && t > 0) {
    w.word = __ballot_sync(0xffffffffu, w.next != 0);
    w.next = byte_at(awake, t + 32 + lane, T, B, b);
  }
  return (w.word >> (t & 31)) & 1u;
}

}  // namespace wake
