// libtiff's CCITT decoders (tif_fax3.c, tif_fax3.h) as Pillow's libtiff
// runs them, written for the port: Modified Huffman (compression 2, and
// 32771 with its rows word-aligned), T.4 one- and two-dimensional
// (compression 3) and T.6 (compression 4).
//
// The state machine is libtiff's, step for step, so that damaged data
// reads as it reads there:
//   * the bits are gathered least significant first from bytes passed
//     through a bit-reversal table (FillOrder 1); past the data's end
//     NeedBits pads with zeros once, then stops;
//   * the code tables are built as mkg3states builds them: an entry of
//     (state, width, run) for each 7-bit (modes), 12-bit (white) and
//     13-bit (black) pattern, the EOL as 7 or 11 zero bits, a pattern no
//     code starts unknown (state 0, width 0);
//   * the runs of a row are gathered in an array of libtiff's size
//     (rowpixels + 1 rounded up to 32, twice that for a reference line),
//     a run past it is an error; a row that does not add up to the width
//     is cut or padded as CLEANUP_RUNS does; a row is filled from its runs
//     (white 0 bits, black 1 bits), bits past the width left as they were;
//   * T.4 rows each start at an EOL (SYNC_EOL: eleven zero bits, zero
//     fill, the one bit), 2-D rows with their tag bit; MH rows end at the
//     next byte (or, for 32771, the next 16-bit word of the file); T.6
//     rows follow each other, the previous row the reference.
// A strip that ends early is an error (Pillow then refuses the file),
// except in T.6 once a row is done: libtiff keeps the rows it decoded.

#include "fax.h"

#include <algorithm>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace mmst_fax {

namespace {

enum {
  S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
  S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};

struct TabEnt {
  uint8_t State, Width;
  uint32_t Param;
};

// T.4's codes, most significant bit first: terminating codes of the runs
// 0 to 63, make-up codes of 64 to 1728 (a step of 64), and the make-up
// codes common to both colours, 1792 to 2560
const char* const kWhiteTerm[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
    "10011", "10100", "00111", "01000", "001000", "000011", "110100",
    "110101", "101010", "101011", "0100111", "0001100", "0001000",
    "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011",
    "00010010", "00010011", "00010100", "00010101", "00010110", "00010111",
    "00101000", "00101001", "00101010", "00101011", "00101100", "00101101",
    "00000100", "00000101", "00001010", "00001011", "01010010", "01010011",
    "01010100", "01010101", "00100100", "00100101", "01011000", "01011001",
    "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100"};
const char* const kWhiteMakeUp[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111",
    "01100100", "01100101", "01101000", "01100111", "011001100",
    "011001101", "011010010", "011010011", "011010100", "011010101",
    "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000",
    "010011011"};
const char* const kBlackTerm[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011",
    "000101", "000100", "0000100", "0000101", "0000111", "00000100",
    "00000111", "000011000", "0000010111", "0000011000", "0000001000",
    "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000",
    "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110",
    "000001010111", "000001100100", "000001100101", "000001010010",
    "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001",
    "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
const char* const kBlackMakeUp[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011",
    "000000110011", "000000110100", "000000110101", "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
const char* const kMakeUp[13] = {
    "00000001000", "00000001100", "00000001101", "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};

// mkg3states FillTable: every pattern of `size` bits that starts with the
// code (read least significant bit first) gets the entry
void fill_table(TabEnt* t, int size, const char* code, uint32_t param,
                int state) {
  const int width = int(std::strlen(code));
  int c = 0;
  for (int i = 0; i < width; ++i)
    if (code[i] == '1') c |= 1 << i;
  for (int k = c; k < (1 << size); k += 1 << width)
    t[k] = {uint8_t(state), uint8_t(width), param};
}

struct Tables {
  TabEnt main[128] = {}, white[4096] = {}, black[8192] = {};
  uint8_t rev[256];
  Tables() {
    fill_table(main, 7, "0001", 0, S_Pass);
    fill_table(main, 7, "001", 0, S_Horiz);
    fill_table(main, 7, "1", 0, S_V0);
    fill_table(main, 7, "011", 1, S_VR);
    fill_table(main, 7, "000011", 2, S_VR);
    fill_table(main, 7, "0000011", 3, S_VR);
    fill_table(main, 7, "010", 1, S_VL);
    fill_table(main, 7, "000010", 2, S_VL);
    fill_table(main, 7, "0000010", 3, S_VL);
    fill_table(main, 7, "0000001", 0, S_Ext);
    fill_table(main, 7, "0000000", 0, S_EOL);
    for (int i = 0; i < 27; ++i)
      fill_table(white, 12, kWhiteMakeUp[i], 64 * (i + 1), S_MakeUpW);
    for (int i = 0; i < 13; ++i)
      fill_table(white, 12, kMakeUp[i], 1792 + 64 * i, S_MakeUp);
    for (int i = 0; i < 64; ++i)
      fill_table(white, 12, kWhiteTerm[i], i, S_TermW);
    fill_table(white, 12, "00000000000", 0, S_EOL);
    for (int i = 0; i < 27; ++i)
      fill_table(black, 13, kBlackMakeUp[i], 64 * (i + 1), S_MakeUpB);
    for (int i = 0; i < 13; ++i)
      fill_table(black, 13, kMakeUp[i], 1792 + 64 * i, S_MakeUp);
    for (int i = 0; i < 64; ++i)
      fill_table(black, 13, kBlackTerm[i], i, S_TermB);
    fill_table(black, 13, "00000000000", 0, S_EOL);
    for (int b = 0; b < 256; ++b) {
      int r = 0;
      for (int i = 0; i < 8; ++i)
        if (b & (1 << i)) r |= 0x80 >> i;
      rev[b] = uint8_t(r);
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

[[noreturn]] void fail(const std::string& why) {
  throw std::runtime_error("CCITT: " + why);
}

// _TIFFFax3fillruns: the runs of a row, white then black, into buf; a run
// past the row is cut to it (and so stored, for the reference line)
void fillruns(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int colour = 0; colour < 2; ++colour) {
      uint32_t run = runs[colour];
      if (x + run > lastx || run > lastx) run = runs[colour] = lastx - x;
      for (uint32_t k = x; k < x + run; ++k) {
        const uint8_t bit = uint8_t(0x80 >> (k & 7));
        if (colour) {
          buf[k >> 3] |= bit;
        } else {
          buf[k >> 3] &= uint8_t(~bit);
        }
      }
      x += run;
    }
  }
}

// The state every decoder starts a strip with (Fax3PreDecode,
// Fax3SetupState): the bit reader, the run arrays, the reference line
// white. libtiff gives each of the two arrays `nruns` entries, zeroed
// once (rowpixels + 1 rounded up to 32, twice that with a reference
// line), 16 bytes a pixel of the row; a row's runs are written one a
// code, so no more of them than the strip has bits (and a few that
// CLEANUP_RUNS adds) are ever written. Past kKeptRuns entries the arrays
// here hold that many (`phys`, with zeros past them, as libtiff's memset
// leaves them), so a wide row of little data costs its data, not its
// width; the bounds libtiff checks stay `nruns`.
constexpr uint64_t kKeptRuns = uint64_t(1) << 21;
struct Strip {
  const uint8_t* cp;
  const uint8_t* ep;
  uint64_t offset;   // where the strip's bytes start in the file
  uint32_t nruns, phys;
  bool noeol = false;   // libtiff's FAXMODE_NOEOL, kept from strip to strip
  std::vector<uint32_t> store;
  uint32_t* curruns;
  uint32_t* refruns;

  Strip(const uint8_t* in, size_t n, uint64_t off, uint32_t rowpixels,
        bool refline, State& st)
      : cp(in), ep(in + n), offset(off), noeol(st.noeol) {
    uint64_t nr = (uint64_t(rowpixels) + 1 + 31) / 32 * 32;
    if (refline) nr *= 2;
    if (nr == 0 || nr * 2 >= (uint64_t(1) << 32))
      fail("row pixels integer overflow");
    nruns = uint32_t(nr);
    // libtiff keeps its arrays, and what rows wrote in them, from strip to
    // strip (a damaged row may read them); so does State where they are
    // not too large (rows of up to a few hundred thousand pixels); wider
    // rows get arrays of their strip's bits, zeroed
    uint32_t* base;
    if (nr * 2 + 8 <= kKeptRuns) {
      phys = nruns;
      if (st.runs.size() < size_t(phys) * 2 + 8)
        st.runs.resize(size_t(phys) * 2 + 8, 0);
      base = st.runs.data();
    } else {
      phys = uint32_t(std::min<uint64_t>(nr, uint64_t(n) * 8 + 16));
      // one slot before the arrays and some after: libtiff reads them on
      // some damaged rows
      store.assign(size_t(phys) * 2 + 8, 0);
      base = store.data();
    }
    curruns = base + 1;
    refruns = refline ? curruns + phys : nullptr;
    if (refruns) {   // Fax3PreDecode: the reference line is white
      refruns[0] = rowpixels;
      refruns[1] = 0;
    }
  }
};

#define DECLARE_STATE(s, rowpixels)                 \
  const Tables& T = tables();                        \
  const uint8_t* bitmap = T.rev;                     \
  const uint8_t* cp = s.cp;                          \
  const uint8_t* const ep = s.ep;                    \
  const int64_t nruns = s.nruns;                     \
  const int64_t phys = s.phys;                       \
  uint32_t* curruns = s.curruns;                     \
  uint32_t* refruns = s.refruns;                     \
  uint32_t BitAcc = 0;                               \
  int BitsAvail = 0;                                 \
  int EOLcnt = 0;                                    \
  const int lastx = int(rowpixels);                  \
  int line = 0;                                      \
  int a0 = 0, RunLength = 0, b1 = 0;                 \
  uint32_t *pa = nullptr, *thisrun = nullptr, *pb = nullptr; \
  const TabEnt* TabEnt = nullptr;                    \
  (void)refruns;                                     \
  (void)phys;                                        \
  (void)b1;                                          \
  (void)pb;                                          \
  (void)curruns;                                     \
  (void)EOLcnt;                                      \
  bool noeol = s.noeol;                              \
  (void)noeol

#define EndOfData() (cp >= ep)
#define NeedBits8(n, eoflab)                                 \
  do {                                                       \
    if (BitsAvail < (n)) {                                   \
      if (EndOfData()) {                                     \
        if (BitsAvail == 0) goto eoflab;                     \
        BitsAvail = (n);                                     \
      } else {                                               \
        BitAcc |= uint32_t(bitmap[*cp++]) << BitsAvail;      \
        BitsAvail += 8;                                      \
      }                                                      \
    }                                                        \
  } while (0)
#define NeedBits16(n, eoflab)                                \
  do {                                                       \
    if (BitsAvail < (n)) {                                   \
      if (EndOfData()) {                                     \
        if (BitsAvail == 0) goto eoflab;                     \
        BitsAvail = (n);                                     \
      } else {                                               \
        BitAcc |= uint32_t(bitmap[*cp++]) << BitsAvail;      \
        if ((BitsAvail += 8) < (n)) {                        \
          if (EndOfData()) {                                 \
            BitsAvail = (n);                                 \
          } else {                                           \
            BitAcc |= uint32_t(bitmap[*cp++]) << BitsAvail;  \
            BitsAvail += 8;                                  \
          }                                                  \
        }                                                    \
      }                                                      \
    }                                                        \
  } while (0)
#define GetBits(n) (BitAcc & ((1u << (n)) - 1))
#define ClrBits(n)     \
  do {                 \
    BitsAvail -= (n);  \
    BitAcc >>= (n);    \
  } while (0)
#define LOOKUP8(wid, tab, eoflab)      \
  do {                                 \
    NeedBits8(wid, eoflab);            \
    TabEnt = tab + GetBits(wid);       \
    ClrBits(TabEnt->Width);            \
  } while (0)
#define LOOKUP16(wid, tab, eoflab)     \
  do {                                 \
    NeedBits16(wid, eoflab);           \
    TabEnt = tab + GetBits(wid);       \
    ClrBits(TabEnt->Width);            \
  } while (0)
#define SETVALUE(x)                                 \
  do {                                              \
    if (pa - thisrun >= nruns) return false;        \
    *pa++ = uint32_t(RunLength + (x));              \
    a0 += (x);                                      \
    RunLength = 0;                                  \
  } while (0)
// libtiff 4.7's SYNC_EOL: the data ending while an EOL's fill is skipped
// (no EOL after all) starts the strip's data again from its first byte
// in "no EOL" mode, at the row being decoded, with no EOL looked for
// again in this strip
#define SYNC_EOL(eoflab, noeollab)               \
  do {                                           \
    if (!noeol) {                                \
      if (EOLcnt == 0) {                         \
        for (;;) {                               \
          NeedBits16(11, eoflab);                \
          if (GetBits(11) == 0) break;           \
          ClrBits(1);                            \
        }                                        \
      }                                          \
      for (;;) {                                 \
        NeedBits8(8, noeollab);                  \
        if (GetBits(8)) break;                   \
        ClrBits(8);                              \
      }                                          \
      while (GetBits(1) == 0) ClrBits(1);        \
      ClrBits(1);                                \
      EOLcnt = 0;                                \
    }                                            \
  } while (0)
// where the data is to be read again without EOLs (the bit reader back at
// the strip's start)
#define NO_EOL_RESTART()   \
  do {                     \
    noeol = true;          \
    cp = s.cp;             \
    BitAcc = 0;            \
    BitsAvail = 0;         \
    EOLcnt = 0;            \
  } while (0)
#define CLEANUP_RUNS()                                   \
  do {                                                   \
    if (RunLength) SETVALUE(0);                          \
    if (a0 != lastx) {                                   \
      while (a0 > lastx && pa > thisrun) a0 -= *--pa;    \
      if (a0 < lastx) {                                  \
        if (a0 < 0) a0 = 0;                              \
        if ((pa - thisrun) & 1) SETVALUE(0);             \
        SETVALUE(lastx - a0);                            \
      } else if (a0 > lastx) {                           \
        SETVALUE(lastx);                                 \
        SETVALUE(0);                                     \
      }                                                  \
    }                                                    \
  } while (0)
#define EXPAND1D(eoflab)                               \
  do {                                                 \
    for (;;) {                                         \
      for (;;) {                                       \
        LOOKUP16(12, T.white, eof1d);                  \
        switch (TabEnt->State) {                       \
          case S_EOL:                                  \
            EOLcnt = 1;                                \
            goto done1d;                               \
          case S_TermW:                                \
            SETVALUE(int(TabEnt->Param));              \
            goto doneWhite1d;                          \
          case S_MakeUpW:                              \
          case S_MakeUp:                               \
            a0 += int(TabEnt->Param);                  \
            RunLength += int(TabEnt->Param);           \
            break;                                     \
          default:                                     \
            goto done1d;                               \
        }                                              \
      }                                                \
    doneWhite1d:                                       \
      if (a0 >= lastx) goto done1d;                    \
      for (;;) {                                       \
        LOOKUP16(13, T.black, eof1d);                  \
        switch (TabEnt->State) {                       \
          case S_EOL:                                  \
            EOLcnt = 1;                                \
            goto done1d;                               \
          case S_TermB:                                \
            SETVALUE(int(TabEnt->Param));              \
            goto doneBlack1d;                          \
          case S_MakeUpB:                              \
          case S_MakeUp:                               \
            a0 += int(TabEnt->Param);                  \
            RunLength += int(TabEnt->Param);           \
            break;                                     \
          default:                                     \
            goto done1d;                               \
        }                                              \
      }                                                \
    doneBlack1d:                                       \
      if (a0 >= lastx) goto done1d;                    \
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;   \
    }                                                  \
  eof1d:                                               \
    CLEANUP_RUNS();                                    \
    goto eoflab;                                       \
  done1d:                                              \
    CLEANUP_RUNS();                                    \
  } while (0)
// past `phys` the entries are zeros, which leave b1 where it is: libtiff
// then walks on to the array's end and fails
#define CHECK_b1                                            \
  do {                                                      \
    if (pa != thisrun)                                      \
      while (b1 <= a0 && b1 < lastx) {                      \
        if (pb - refruns + 1 >= nruns) return false;        \
        if (pb - refruns + 1 >= phys) return false;         \
        b1 += int(pb[0] + pb[1]);                           \
        pb += 2;                                            \
      }                                                     \
  } while (0)
#define EXPAND2D(eoflab)                                          \
  do {                                                            \
    while (a0 < lastx) {                                          \
      if (pa - thisrun >= nruns) return false;                    \
      LOOKUP8(7, T.main, eof2d);                                  \
      switch (TabEnt->State) {                                    \
        case S_Pass:                                              \
          CHECK_b1;                                               \
          if (pb - refruns + 1 >= nruns) return false;            \
          b1 += int(*pb++);                                       \
          RunLength += b1 - a0;                                   \
          a0 = b1;                                                \
          b1 += int(*pb++);                                       \
          break;                                                  \
        case S_Horiz:                                             \
          if ((pa - thisrun) & 1) {                               \
            for (;;) {                                            \
              LOOKUP16(13, T.black, eof2d);                       \
              switch (TabEnt->State) {                            \
                case S_TermB:                                     \
                  SETVALUE(int(TabEnt->Param));                   \
                  goto doneWhite2da;                              \
                case S_MakeUpB:                                   \
                case S_MakeUp:                                    \
                  a0 += int(TabEnt->Param);                       \
                  RunLength += int(TabEnt->Param);                \
                  break;                                          \
                default:                                          \
                  goto badBlack2d;                                \
              }                                                   \
            }                                                     \
          doneWhite2da:;                                          \
            for (;;) {                                            \
              LOOKUP16(12, T.white, eof2d);                       \
              switch (TabEnt->State) {                            \
                case S_TermW:                                     \
                  SETVALUE(int(TabEnt->Param));                   \
                  goto doneBlack2da;                              \
                case S_MakeUpW:                                   \
                case S_MakeUp:                                    \
                  a0 += int(TabEnt->Param);                       \
                  RunLength += int(TabEnt->Param);                \
                  break;                                          \
                default:                                          \
                  goto badWhite2d;                                \
              }                                                   \
            }                                                     \
          doneBlack2da:;                                          \
          } else {                                                \
            for (;;) {                                            \
              LOOKUP16(12, T.white, eof2d);                       \
              switch (TabEnt->State) {                            \
                case S_TermW:                                     \
                  SETVALUE(int(TabEnt->Param));                   \
                  goto doneWhite2db;                              \
                case S_MakeUpW:                                   \
                case S_MakeUp:                                    \
                  a0 += int(TabEnt->Param);                       \
                  RunLength += int(TabEnt->Param);                \
                  break;                                          \
                default:                                          \
                  goto badWhite2d;                                \
              }                                                   \
            }                                                     \
          doneWhite2db:;                                          \
            for (;;) {                                            \
              LOOKUP16(13, T.black, eof2d);                       \
              switch (TabEnt->State) {                            \
                case S_TermB:                                     \
                  SETVALUE(int(TabEnt->Param));                   \
                  goto doneBlack2db;                              \
                case S_MakeUpB:                                   \
                case S_MakeUp:                                    \
                  a0 += int(TabEnt->Param);                       \
                  RunLength += int(TabEnt->Param);                \
                  break;                                          \
                default:                                          \
                  goto badBlack2d;                                \
              }                                                   \
            }                                                     \
          doneBlack2db:;                                          \
          }                                                       \
          CHECK_b1;                                               \
          break;                                                  \
        case S_V0:                                                \
          CHECK_b1;                                               \
          SETVALUE(b1 - a0);                                      \
          if (pb - refruns >= nruns) return false;                \
          b1 += int(*pb++);                                       \
          break;                                                  \
        case S_VR:                                                \
          CHECK_b1;                                               \
          SETVALUE(b1 - a0 + int(TabEnt->Param));                 \
          if (pb - refruns >= nruns) return false;                \
          b1 += int(*pb++);                                       \
          break;                                                  \
        case S_VL:                                                \
          CHECK_b1;                                               \
          if (b1 < int(a0 + TabEnt->Param)) goto eol2d;           \
          SETVALUE(b1 - a0 - int(TabEnt->Param));                 \
          b1 -= int(*--pb);                                       \
          break;                                                  \
        case S_Ext:                                               \
          *pa++ = uint32_t(lastx - a0);                           \
          goto eol2d;                                             \
        case S_EOL:                                               \
          *pa++ = uint32_t(lastx - a0);                           \
          NeedBits8(4, eof2d);                                    \
          ClrBits(4);                                             \
          EOLcnt = 1;                                             \
          goto eol2d;                                             \
        default:                                                  \
        badMain2d:                                                \
          goto eol2d;                                             \
        badBlack2d:                                               \
          goto eol2d;                                             \
        badWhite2d:                                               \
          goto eol2d;                                             \
        eof2d:                                                    \
          CLEANUP_RUNS();                                         \
          goto eoflab;                                            \
      }                                                           \
    }                                                             \
    if (RunLength) {                                              \
      if (RunLength + a0 < lastx) {                               \
        NeedBits8(1, eof2d);                                      \
        if (!GetBits(1)) goto badMain2d;                          \
        ClrBits(1);                                               \
      }                                                           \
      SETVALUE(0);                                                \
    }                                                             \
  eol2d:                                                          \
    CLEANUP_RUNS();                                               \
  } while (0)

// Fax3DecodeRLE: compression 2 (rows byte-aligned) and 32771 (rows
// aligned to 16-bit words of the file)
bool decode_rle(Strip& s, bool word, uint32_t rowpixels, int64_t occ,
                int64_t rowbytes, uint8_t* buf) {
  DECLARE_STATE(s, rowpixels);
  thisrun = curruns;
  while (occ > 0) {
    a0 = 0;
    RunLength = 0;
    pa = thisrun;
    EXPAND1D(EOFRLE);
    fillruns(buf, thisrun, pa, uint32_t(lastx));
    if (!word) {
      const int k = BitsAvail - (BitsAvail & ~7);
      ClrBits(k);
    } else {
      const int k = BitsAvail - (BitsAvail & ~15);
      ClrBits(k);
      // isAligned(cp, uint16): the file's bytes as Pillow maps them
      if (BitsAvail == 0 && ((s.offset + uint64_t(cp - s.cp)) & 1)) cp++;
    }
    buf += rowbytes;
    occ -= rowbytes;
    line++;
    continue;
  EOFRLE:
    fillruns(buf, thisrun, pa, uint32_t(lastx));
    return false;
  }
  return true;
}

// Fax3Decode1D: T.4, one-dimensional
bool decode_1d(Strip& s, uint32_t rowpixels, int64_t occ, int64_t rowbytes,
               uint8_t* buf) {
  DECLARE_STATE(s, rowpixels);
  thisrun = curruns;
  while (occ > 0) {
  row1d:
    a0 = 0;
    RunLength = 0;
    pa = thisrun;
    SYNC_EOL(EOF1D, NOEOL1D);
    EXPAND1D(EOF1Da);
    fillruns(buf, thisrun, pa, uint32_t(lastx));
    buf += rowbytes;
    occ -= rowbytes;
    line++;
    continue;
  NOEOL1D:
    NO_EOL_RESTART();
    goto row1d;
  EOF1D:
    CLEANUP_RUNS();
  EOF1Da:
    fillruns(buf, thisrun, pa, uint32_t(lastx));
    s.noeol = noeol;
    return false;
  }
  s.noeol = noeol;
  return true;
}

// Fax3Decode2D: T.4, each row tagged one- or two-dimensional
bool decode_2d(Strip& s, uint32_t rowpixels, int64_t occ, int64_t rowbytes,
               uint8_t* buf) {
  DECLARE_STATE(s, rowpixels);
  bool is1D;
  while (occ > 0) {
  row2d:
    a0 = 0;
    RunLength = 0;
    pa = thisrun = curruns;
    SYNC_EOL(EOF2D, NOEOL2D);
    NeedBits8(1, EOF2D);
    is1D = GetBits(1);
    ClrBits(1);
    pb = refruns;
    b1 = int(*pb++);
    if (is1D) {
      EXPAND1D(EOF2Da);
    } else {
      EXPAND2D(EOF2Da);
    }
    fillruns(buf, thisrun, pa, uint32_t(lastx));
    if (pa - thisrun < nruns) SETVALUE(0);
    std::swap(curruns, refruns);
    buf += rowbytes;
    occ -= rowbytes;
    line++;
    continue;
  NOEOL2D:
    NO_EOL_RESTART();
    goto row2d;
  EOF2D:
    CLEANUP_RUNS();
  EOF2Da:
    fillruns(buf, thisrun, pa, uint32_t(lastx));
    s.noeol = noeol;
    return false;
  }
  s.noeol = noeol;
  return true;
}

// Fax4Decode: T.6
bool decode_g4(Strip& s, uint32_t rowpixels, int64_t occ, int64_t rowbytes,
               uint8_t* buf) {
  DECLARE_STATE(s, rowpixels);
  while (occ > 0) {
    a0 = 0;
    RunLength = 0;
    pa = thisrun = curruns;
    pb = refruns;
    b1 = int(*pb++);
    EXPAND2D(EOFG4);
    if (EOLcnt) goto EOFG4;
    fillruns(buf, thisrun, pa, uint32_t(lastx));
    SETVALUE(0);
    std::swap(curruns, refruns);
    buf += rowbytes;
    occ -= rowbytes;
    line++;
    continue;
  EOFG4:
    fillruns(buf, thisrun, pa, uint32_t(lastx));
    return line != 0;   // libtiff keeps a badly terminated strip's rows
  }
  return true;
}

#undef EndOfData
#undef NeedBits8
#undef NeedBits16
#undef GetBits
#undef ClrBits
#undef LOOKUP8
#undef LOOKUP16
#undef SETVALUE
#undef SYNC_EOL
#undef NO_EOL_RESTART
#undef CLEANUP_RUNS
#undef EXPAND1D
#undef CHECK_b1
#undef EXPAND2D


}  // namespace

void decode(int compression, int options, const uint8_t* in, size_t n,
            uint64_t offset, int width, int rows, int64_t rowbytes,
            uint8_t* out, State& st) {
  if (width <= 0 || rows <= 0 || rowbytes < (int64_t(width) + 7) / 8)
    fail("inconsistent number of bytes per row");
  const int64_t occ = int64_t(rows) * rowbytes;
  bool ok;
  if (compression == 2 || compression == 32771) {
    Strip s(in, n, offset, uint32_t(width), false, st);
    ok = decode_rle(s, compression == 32771, uint32_t(width), occ, rowbytes,
                    out);
  } else if (compression == 3) {
    Strip s(in, n, offset, uint32_t(width), options & 1, st);
    ok = options & 1 ? decode_2d(s, uint32_t(width), occ, rowbytes, out)
                     : decode_1d(s, uint32_t(width), occ, rowbytes, out);
    st.noeol = s.noeol;
  } else if (compression == 4) {
    Strip s(in, n, offset, uint32_t(width), true, st);
    ok = decode_g4(s, uint32_t(width), occ, rowbytes, out);
  } else {
    fail("compression " + std::to_string(compression) + " is not CCITT");
  }
  if (!ok) fail("the data ends early or is corrupt");
}

}  // namespace mmst_fax
